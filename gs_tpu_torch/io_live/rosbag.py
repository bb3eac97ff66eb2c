"""Pure-Python rosbag (format v2.0) reader/writer + generic ROS msg codec —
the port's copy of ``gs_tpu/io_live/rosbag.py``; a bag either package writes
is the other's, byte for byte.

Lets users with existing reference captures migrate offline: the reference's
converters consume real ``.bag`` files (ref: convert_orb_topic.py:100-148
reads image/pose/cloud topics via ``rosbag.Bag``;
convert_visual_merged_msg.py:482-505 iterates ``/Visual_Merged``), while this
framework records its own ``.gstream`` files. This module reads (and writes)
the bag container without any ROS installation:

* container: ``#ROSBAG V2.0`` + a sequence of records (header fields +
  data blob); chunked bags with ``none``/``bz2`` compression are supported
  (``lz4`` needs the ros lz4 framing lib — not in this env, clear error).
* messages: decoded GENERICALLY from the connection record's embedded
  ``message_definition`` (every bag carries the full text of each message
  type it contains), so custom types like ``gs_slam_msgs/visual_merged_msg``
  (ref: submodules/ros_workspace/src/gs_slam_msgs/msg/visual_merged_msg.msg)
  decode without hand-written schemas.

``frames_from_bag`` / ``frames_from_visual_merged`` adapt decoded messages
into :class:`gs_tpu_torch.io_live.stream.Frame`, feeding the same
stream -> COLMAP pipeline as ``.gstream`` input (apps/convert_stream.py).
"""
from __future__ import annotations

import bz2
import hashlib
import io
import re
import struct
from types import SimpleNamespace
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07

_PRIMITIVES = {
    "bool": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "byte": ("b", 1), "char": ("B", 1),
    "int16": ("h", 2), "uint16": ("H", 2),
    "int32": ("i", 4), "uint32": ("I", 4),
    "int64": ("q", 8), "uint64": ("Q", 8),
    "float32": ("f", 4), "float64": ("d", 8),
}


class RosTime(NamedTuple):
    secs: int
    nsecs: int

    def to_sec(self) -> float:
        return self.secs + self.nsecs * 1e-9


# --------------------------------------------------------------- container

def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode("ascii")] = value
    return fields


def _encode_header(fields: Dict[str, bytes]) -> bytes:
    out = []
    for name, value in fields.items():
        f = name.encode("ascii") + b"=" + value
        out.append(struct.pack("<I", len(f)) + f)
    return b"".join(out)


def _read_record(f) -> Optional[Tuple[Dict[str, bytes], bytes]]:
    head = f.read(4)
    if len(head) < 4:
        return None
    (hlen,) = struct.unpack("<I", head)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    return header, f.read(dlen)


class Connection(NamedTuple):
    conn_id: int
    topic: str
    datatype: str
    md5sum: str
    message_definition: str


class BagMessage(NamedTuple):
    topic: str
    raw: bytes               # serialized message body
    conn: Connection
    time: RosTime            # bag receipt time


def _parse_connection(header: Dict[str, bytes], data: bytes) -> Connection:
    (cid,) = struct.unpack("<I", header["conn"])
    chdr = _parse_header(data)
    return Connection(
        conn_id=cid,
        topic=chdr.get("topic", header.get("topic", b"")).decode(),
        datatype=chdr.get("type", b"").decode(),
        md5sum=chdr.get("md5sum", b"").decode(),
        message_definition=chdr.get("message_definition", b"").decode(),
    )


def read_bag_messages(path: str, topics=None) -> Iterator[BagMessage]:
    """Yield messages in file order (the write order of a live recording).

    Mirrors ``rosbag.Bag.read_messages(topics=...)`` as the reference uses it
    (ref: convert_orb_topic.py:84, convert_visual_merged_msg.py:484) but
    yields the RAW body + connection; pair with :func:`decode_message`.
    """
    topics = set(topics) if topics else None
    conns: Dict[int, Connection] = {}
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 file")
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            header, data = rec
            op = header["op"][0]
            if op == OP_CONN:
                c = _parse_connection(header, data)
                conns[c.conn_id] = c
            elif op == OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "bz2":
                    data = bz2.decompress(data)
                elif comp != "none":
                    raise ValueError(
                        f"unsupported chunk compression {comp!r} (only "
                        "none/bz2 without ROS libs; re-record or "
                        "`rosbag decompress` the bag)")
                sub = io.BytesIO(data)
                while True:
                    srec = _read_record(sub)
                    if srec is None:
                        break
                    sh, sd = srec
                    sop = sh["op"][0]
                    if sop == OP_CONN:
                        c = _parse_connection(sh, sd)
                        conns[c.conn_id] = c
                    elif sop == OP_MSG:
                        m = _emit(sh, sd, conns, topics)
                        if m is not None:
                            yield m
            elif op == OP_MSG:
                m = _emit(header, data, conns, topics)
                if m is not None:
                    yield m
            # OP_BAGHDR / OP_INDEX / OP_CHUNKINFO: skipped (index data is
            # redundant with a sequential scan)


def _emit(header, data, conns, topics) -> Optional[BagMessage]:
    (cid,) = struct.unpack("<I", header["conn"])
    conn = conns.get(cid)
    if conn is None:
        raise ValueError(f"message references unknown connection {cid}")
    if topics is not None and conn.topic not in topics:
        return None
    secs, nsecs = struct.unpack("<II", header["time"])
    return BagMessage(conn.topic, data, conn, RosTime(secs, nsecs))


# ---------------------------------------------------------- message codec

_SEP = re.compile(r"^=+\s*$", re.M)


class _Field(NamedTuple):
    name: str
    type: str        # base type (no array suffix)
    array: Optional[int]   # None = scalar, -1 = variable, n = fixed


def _parse_fields(block: str) -> List[_Field]:
    fields = []
    for line in block.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"^(\S+)\s+(\S+)\s*$", line)
        if not m:
            if "=" in line:        # constant, e.g. "uint8 DEBUG=1"
                continue
            raise ValueError(f"cannot parse msg field line {line!r}")
        ftype, name = m.groups()
        if "=" in name:            # constant written without spaces
            continue
        array = None
        am = re.match(r"^(.*)\[(\d*)\]$", ftype)
        if am:
            ftype = am.group(1)
            array = int(am.group(2)) if am.group(2) else -1
        fields.append(_Field(name, ftype, array))
    return fields


class MessageSchema:
    """All types embedded in one connection's ``message_definition``."""

    def __init__(self, datatype: str, definition: str):
        self.root = datatype
        self.types: Dict[str, List[_Field]] = {}
        blocks = _SEP.split(definition)
        self.types[datatype] = _parse_fields(blocks[0])
        for block in blocks[1:]:
            m = re.search(r"^MSG:\s*(\S+)\s*$", block, re.M)
            if not m:
                continue
            name = m.group(1)
            body = block[m.end():]
            self.types[name] = _parse_fields(body)

    def resolve(self, ftype: str, context: str) -> str:
        """Full type name for a field type as written in ``context``'s pkg."""
        if ftype == "Header":
            return "std_msgs/Header"
        if ftype in self.types:
            return ftype
        pkg = context.rsplit("/", 1)[0] if "/" in context else ""
        if pkg and f"{pkg}/{ftype}" in self.types:
            return f"{pkg}/{ftype}"
        for full in self.types:          # unique short-name match
            if full.rsplit("/", 1)[-1] == ftype:
                return full
        raise KeyError(f"type {ftype!r} not found in message definition")


def _decode_value(schema: MessageSchema, ftype: str, context: str,
                  buf: bytes, off: int):
    if ftype in _PRIMITIVES:
        fmt, size = _PRIMITIVES[ftype]
        (v,) = struct.unpack_from("<" + fmt, buf, off)
        return (bool(v) if ftype == "bool" else v), off + size
    if ftype == "string":
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        return buf[off:off + n].decode("utf-8", "replace"), off + n
    if ftype in ("time", "duration"):
        s, ns = struct.unpack_from("<II", buf, off)
        return RosTime(s, ns), off + 8
    full = schema.resolve(ftype, context)
    return _decode_struct(schema, full, buf, off)


def _decode_struct(schema: MessageSchema, full: str, buf: bytes, off: int):
    out = SimpleNamespace()
    for fld in schema.types[full]:
        if fld.array is None:
            v, off = _decode_value(schema, fld.type, full, buf, off)
        else:
            n = fld.array
            if n < 0:
                (n,) = struct.unpack_from("<I", buf, off)
                off += 4
            if fld.type in _PRIMITIVES:
                fmt, size = _PRIMITIVES[fld.type]
                v = np.frombuffer(buf, np.dtype("<" + fmt), n, off)
                if fld.type == "bool":
                    v = v.astype(bool)
                off += n * size
            else:
                v = []
                for _ in range(n):
                    item, off = _decode_value(schema, fld.type, full,
                                              buf, off)
                    v.append(item)
        setattr(out, fld.name, v)
    return out, off


def decode_message(msg: BagMessage):
    """Decode one bag message into nested attribute objects.

    Access mirrors rospy message objects (``m.header.stamp.to_sec()``,
    ``m.pose.orientation.w`` ...), which is what the reference converters
    read (ref: convert_orb_topic.py:86-145)."""
    schema = MessageSchema(msg.conn.datatype, msg.conn.message_definition)
    out, off = _decode_struct(schema, schema.root, msg.raw, 0)
    if off != len(msg.raw):
        raise ValueError(
            f"{msg.conn.datatype}: decoded {off} of {len(msg.raw)} bytes "
            "(schema/stream mismatch)")
    return out


def _encode_value(schema: MessageSchema, ftype: str, context: str, v, out):
    if ftype in _PRIMITIVES:
        fmt, _ = _PRIMITIVES[ftype]
        out.append(struct.pack("<" + fmt, int(v) if fmt != "f" and fmt != "d"
                               else float(v)))
        return
    if ftype == "string":
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        out.append(struct.pack("<I", len(b)) + b)
        return
    if ftype in ("time", "duration"):
        if isinstance(v, (int, float)):
            v = RosTime(int(v), int((v - int(v)) * 1e9))
        out.append(struct.pack("<II", v[0], v[1]))
        return
    full = schema.resolve(ftype, context)
    _encode_struct(schema, full, v, out)


def _encode_struct(schema: MessageSchema, full: str, obj, out):
    for fld in schema.types[full]:
        v = obj[fld.name] if isinstance(obj, dict) else getattr(obj, fld.name)
        if fld.array is None:
            _encode_value(schema, fld.type, full, v, out)
        else:
            n = fld.array
            if n < 0:
                n = len(v)
                out.append(struct.pack("<I", n))
            if fld.type in _PRIMITIVES and isinstance(v, (bytes, np.ndarray)):
                fmt, _ = _PRIMITIVES[fld.type]
                arr = (np.frombuffer(v, np.uint8) if isinstance(v, bytes)
                       else np.asarray(v))
                out.append(arr.astype("<" + fmt).tobytes())
            else:
                if len(v) != n:
                    raise ValueError(f"{full}.{fld.name}: length {len(v)} "
                                     f"!= declared {n}")
                for item in v:
                    _encode_value(schema, fld.type, full, item, out)


def encode_message(datatype: str, definition: str, obj) -> bytes:
    """Serialize nested dicts/namespaces into ROS wire bytes."""
    schema = MessageSchema(datatype, definition)
    out: List[bytes] = []
    _encode_struct(schema, schema.root, obj, out)
    return b"".join(out)


def message_md5(datatype: str, definition: str,
                _cache: Optional[Dict[str, str]] = None) -> str:
    """genmsg-compatible md5: constants + fields, nested types replaced by
    their own md5 (so standard types hash to their published constants —
    std_msgs/Header == 2176decaecbce78abc3b96ef049fabed, asserted in tests).
    """
    schema = MessageSchema(datatype, definition)
    cache: Dict[str, str] = {} if _cache is None else _cache

    def compute(full: str) -> str:
        if full in cache:
            return cache[full]
        const_lines, field_lines = [], []
        # constants keep their source text (normalized spacing)
        block = _raw_block(definition, full, root=full == datatype)
        for line in block.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^(\S+)\s+(\S+)\s*=\s*(.+?)\s*$", line)
            if m and "[" not in m.group(1):
                const_lines.append(f"{m.group(1)} {m.group(2)}={m.group(3)}")
        for fld in schema.types[full]:
            if fld.type in _PRIMITIVES or fld.type in ("string", "time",
                                                       "duration"):
                suffix = ("" if fld.array is None
                          else ("[]" if fld.array < 0 else f"[{fld.array}]"))
                field_lines.append(f"{fld.type}{suffix} {fld.name}")
            else:
                sub = schema.resolve(fld.type, full)
                field_lines.append(f"{compute(sub)} {fld.name}")
        text = "\n".join(const_lines + field_lines)
        h = hashlib.md5(text.encode()).hexdigest()
        cache[full] = h
        return h

    return compute(datatype)


def _raw_block(definition: str, full: str, root: bool) -> str:
    blocks = _SEP.split(definition)
    if root:
        return blocks[0]
    for block in blocks[1:]:
        m = re.search(r"^MSG:\s*(\S+)\s*$", block, re.M)
        if m and m.group(1) == full:
            return block[m.end():]
    return ""


# ----------------------------------------------------------------- writer

class BagWriter:
    """Minimal rosbag v2.0 writer (one chunk per ``flush``, none/bz2).

    Used for test fixtures and to export ``.gstream`` recordings back into
    ROS-toolable bags. Bags are written unindexed-but-valid: the official
    rosbag reader handles index-free bags (it reindexes on demand), and
    :func:`read_bag_messages` scans sequentially anyway."""

    def __init__(self, path: str, compression: str = "none"):
        assert compression in ("none", "bz2")
        self.compression = compression
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        # bag header record, padded to 4096 bytes like the reference writer
        hdr = _encode_header({
            "op": bytes([OP_BAGHDR]),
            "index_pos": struct.pack("<Q", 0),
            "conn_count": struct.pack("<I", 0),
            "chunk_count": struct.pack("<I", 0),
        })
        pad = b" " * (4096 - len(hdr) - 8)
        self.f.write(struct.pack("<I", len(hdr)) + hdr
                     + struct.pack("<I", len(pad)) + pad)
        self._conns: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._pending: List[bytes] = []

    def _record(self, header: Dict[str, bytes], data: bytes) -> bytes:
        h = _encode_header(header)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(data)) + data)

    def write(self, topic: str, datatype: str, definition: str, obj,
              t: float, md5sum: Optional[str] = None):
        if topic not in self._conns:
            cid = len(self._conns)
            self._conns[topic] = cid
            chdr = _encode_header({
                "topic": topic.encode(),
                "type": datatype.encode(),
                "md5sum": (md5sum or message_md5(datatype,
                                                 definition)).encode(),
                "message_definition": definition.encode(),
            })
            rec = self._record({"op": bytes([OP_CONN]),
                                "conn": struct.pack("<I", cid),
                                "topic": topic.encode()}, chdr)
            self._conn_records.append(rec)
            self._pending.append(rec)
        raw = (obj if isinstance(obj, (bytes, bytearray))
               else encode_message(datatype, definition, obj))
        secs, nsecs = int(t), int((t - int(t)) * 1e9)
        self._pending.append(self._record(
            {"op": bytes([OP_MSG]),
             "conn": struct.pack("<I", self._conns[topic]),
             "time": struct.pack("<II", secs, nsecs)}, raw))

    def flush(self):
        if not self._pending:
            return
        blob = b"".join(self._pending)
        data = bz2.compress(blob) if self.compression == "bz2" else blob
        self.f.write(self._record(
            {"op": bytes([OP_CHUNK]),
             "compression": self.compression.encode(),
             "size": struct.pack("<I", len(blob))}, data))
        self._pending = []

    def close(self):
        self.flush()
        # trailing connection records so index-seeking readers find them
        for rec in self._conn_records:
            self.f.write(rec)
        self.f.close()


# --------------------------------------------- standard message definitions
# Full definition texts (with dependency blocks) for the types the writer
# emits — the same text rosbag embeds in connection records. These are the
# published ROS common_msgs schemas (interchange format, like the COLMAP
# struct layouts in data/colmap.py).

HEADER_DEF = """uint32 seq
time stamp
string frame_id"""

_SEP_LINE = "=" * 80

IMAGE_DEF = f"""Header header
uint32 height
uint32 width
string encoding
uint8 is_bigendian
uint32 step
uint8[] data
{_SEP_LINE}
MSG: std_msgs/Header
{HEADER_DEF}"""

CAMERA_INFO_DEF = f"""Header header
uint32 height
uint32 width
string distortion_model
float64[] D
float64[9] K
float64[9] R
float64[12] P
uint32 binning_x
uint32 binning_y
sensor_msgs/RegionOfInterest roi
{_SEP_LINE}
MSG: std_msgs/Header
{HEADER_DEF}
{_SEP_LINE}
MSG: sensor_msgs/RegionOfInterest
uint32 x_offset
uint32 y_offset
uint32 height
uint32 width
bool do_rectify"""

POSE_STAMPED_DEF = f"""Header header
geometry_msgs/Pose pose
{_SEP_LINE}
MSG: std_msgs/Header
{HEADER_DEF}
{_SEP_LINE}
MSG: geometry_msgs/Pose
geometry_msgs/Point position
geometry_msgs/Quaternion orientation
{_SEP_LINE}
MSG: geometry_msgs/Point
float64 x
float64 y
float64 z
{_SEP_LINE}
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w"""

TRANSFORM_STAMPED_DEF = f"""Header header
string child_frame_id
geometry_msgs/Transform transform
{_SEP_LINE}
MSG: std_msgs/Header
{HEADER_DEF}
{_SEP_LINE}
MSG: geometry_msgs/Transform
geometry_msgs/Vector3 translation
geometry_msgs/Quaternion rotation
{_SEP_LINE}
MSG: geometry_msgs/Vector3
float64 x
float64 y
float64 z
{_SEP_LINE}
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w"""

POINTCLOUD2_DEF = f"""Header header
uint32 height
uint32 width
sensor_msgs/PointField[] fields
bool is_bigendian
uint32 point_step
uint32 row_step
uint8[] data
bool is_dense
{_SEP_LINE}
MSG: std_msgs/Header
{HEADER_DEF}
{_SEP_LINE}
MSG: sensor_msgs/PointField
uint8 INT8=1
uint8 UINT8=2
uint8 INT16=3
uint8 UINT16=4
uint8 INT32=5
uint8 UINT32=6
uint8 FLOAT32=7
uint8 FLOAT64=8
string name
uint32 offset
uint8 datatype
uint32 count"""

# ref: submodules/ros_workspace/src/gs_slam_msgs/msg/visual_merged_msg.msg
VISUAL_MERGED_DEF = "\n".join([
    "sensor_msgs/Image Image",
    "sensor_msgs/CameraInfo CameraInfo",
    "geometry_msgs/TransformStamped CameraPose",
    "sensor_msgs/PointCloud2 Local_Map",
    _SEP_LINE,
    "MSG: sensor_msgs/Image",
    IMAGE_DEF.split(_SEP_LINE)[0].strip(),
    _SEP_LINE,
    "MSG: sensor_msgs/CameraInfo",
    CAMERA_INFO_DEF.split(_SEP_LINE)[0].strip(),
    _SEP_LINE,
    "MSG: sensor_msgs/RegionOfInterest",
    CAMERA_INFO_DEF.split("MSG: sensor_msgs/RegionOfInterest")[1].strip(),
    _SEP_LINE,
    "MSG: geometry_msgs/TransformStamped",
    TRANSFORM_STAMPED_DEF.split(_SEP_LINE)[0].strip(),
    _SEP_LINE,
    "MSG: geometry_msgs/Transform",
    "geometry_msgs/Vector3 translation",
    "geometry_msgs/Quaternion rotation",
    _SEP_LINE,
    "MSG: geometry_msgs/Vector3",
    "float64 x\nfloat64 y\nfloat64 z",
    _SEP_LINE,
    "MSG: geometry_msgs/Quaternion",
    "float64 x\nfloat64 y\nfloat64 z\nfloat64 w",
    _SEP_LINE,
    "MSG: sensor_msgs/PointCloud2",
    POINTCLOUD2_DEF.split(_SEP_LINE)[0].strip(),
    _SEP_LINE,
    "MSG: sensor_msgs/PointField",
    POINTCLOUD2_DEF.split("MSG: sensor_msgs/PointField")[1].strip(),
    _SEP_LINE,
    "MSG: std_msgs/Header",
    HEADER_DEF,
])


# ------------------------------------------------------------ Frame adapters

def _image_to_array(msg) -> np.ndarray:
    from .stream import decode_image
    enc = msg.encoding
    data = bytes(msg.data)
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    if enc in ("rgb8", "bgr8"):
        arr = np.frombuffer(data, np.uint8)[:h * step]
        arr = arr.reshape(h, step)[:, :w * 3].reshape(h, w, 3)
        return arr[:, :, ::-1] if enc == "bgr8" else arr
    if enc in ("rgba8", "bgra8"):
        arr = np.frombuffer(data, np.uint8)[:h * step]
        arr = arr.reshape(h, step)[:, :w * 4].reshape(h, w, 4)[:, :, :3]
        return arr[:, :, ::-1] if enc == "bgra8" else arr
    if enc == "mono8":
        arr = np.frombuffer(data, np.uint8)[:h * step]
        arr = arr.reshape(h, step)[:, :w]
        return np.repeat(arr[:, :, None], 3, axis=2)
    return decode_image(data, enc, w, h)


def _cloud_to_xyz(msg) -> Optional[np.ndarray]:
    """PointCloud2 -> [N, 3] float32, honoring the field offsets
    (ref: convert_orb_topic.py:203-224 assumes fff at offset 0; this reads
    the declared x/y/z offsets so XYZRGB / padded clouds decode too)."""
    n = int(msg.width) * int(msg.height)
    if n == 0:
        return None
    step = int(msg.point_step)
    data = np.frombuffer(bytes(msg.data), np.uint8)
    data = data[:n * step].reshape(n, step)
    offs = {f.name: int(f.offset) for f in msg.fields}
    if not all(k in offs for k in ("x", "y", "z")):
        return None
    cols = []
    for k in ("x", "y", "z"):
        o = offs[k]
        cols.append(data[:, o:o + 4].copy().view("<f4")[:, 0])
    xyz = np.stack(cols, axis=1)
    return xyz[np.isfinite(xyz).all(axis=1)]


def frames_from_visual_merged(path: str, topic: str = "/Visual_Merged",
                              points_every: int = 30) -> List:
    """Bag of ``visual_merged_msg`` -> list[Frame] (one self-contained posed
    frame per message; local map attached every ``points_every``-th frame,
    ref: convert_visual_merged_msg.py:477-505 ``iteration_pc = 30``)."""
    from .stream import Frame
    frames = []
    for i, bm in enumerate(read_bag_messages(path, topics=[topic])):
        m = decode_message(bm)
        tr = m.CameraPose.transform
        pts = _cloud_to_xyz(m.Local_Map) if i % points_every == 0 else None
        frames.append(Frame(
            stamp=m.Image.header.stamp.to_sec() or bm.time.to_sec(),
            image=_image_to_array(m.Image),
            K=np.asarray(m.CameraInfo.K, np.float64).reshape(3, 3),
            qvec=np.array([tr.rotation.w, tr.rotation.x, tr.rotation.y,
                           tr.rotation.z]),
            tvec=np.array([tr.translation.x, tr.translation.y,
                           tr.translation.z]),
            pose_convention="c2w",
            points=pts))
    return frames


def frames_from_bag(path: str,
                    image_topic: str = "/camera/color/image_raw",
                    pose_topic: str = "/orb_slam3/camera_pose",
                    info_topic: str = "/camera/color/camera_info",
                    points_topic: str = "/orb_slam3/all_points",
                    threshold: float = 0.033) -> List:
    """Separate-topic bag (ORB-SLAM3 rig) -> list[Frame].

    Pairs each image with the nearest later pose within ``threshold`` seconds
    by header stamp, exactly the reference's sync loop
    (ref: convert_orb_topic.py:96-116); the LAST cloud message wins
    (ref: convert_orb_topic.py:160-166 keeps iterating to the last).
    """
    from .stream import Frame
    images, poses, infos, last_cloud = [], [], [], None
    for bm in read_bag_messages(path, topics=[image_topic, pose_topic,
                                              info_topic, points_topic]):
        m = decode_message(bm)
        stamp = (m.header.stamp.to_sec() if hasattr(m, "header")
                 else bm.time.to_sec()) or bm.time.to_sec()
        if bm.topic == image_topic:
            images.append((stamp, m))
        elif bm.topic == pose_topic:
            poses.append((stamp, m))
        elif bm.topic == info_topic:
            infos.append(m)
        elif bm.topic == points_topic:
            last_cloud = m

    images.sort(key=lambda x: x[0])
    poses.sort(key=lambda x: x[0])
    K = (np.asarray(infos[0].K, np.float64).reshape(3, 3) if infos
         else np.eye(3))
    cloud = _cloud_to_xyz(last_cloud) if last_cloud is not None else None

    frames = []
    pi = 0
    for stamp, img in images:
        while pi < len(poses) and poses[pi][0] < stamp - threshold:
            pi += 1
        if pi >= len(poses):
            break
        if abs(poses[pi][0] - stamp) > threshold:
            continue
        p = poses[pi][1].pose
        pi += 1
        frames.append(Frame(
            stamp=stamp,
            image=_image_to_array(img),
            K=K,
            qvec=np.array([p.orientation.w, p.orientation.x,
                           p.orientation.y, p.orientation.z]),
            tvec=np.array([p.position.x, p.position.y, p.position.z]),
            pose_convention="c2w",
            # attach the (single, global) map cloud to the first frame only
            points=cloud if not frames else None))
    return frames
