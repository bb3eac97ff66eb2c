"""The port's LPIPS (gs_tpu_torch/ops/lpips.py) against gs_tpu.ops.lpips on
the CPU with seeded random weights (the real VGG16 and linear-head weights
are not in the repository): the value at 32x48, the committed tap fixture
tests/golden/lpips_taps.npz without JAX, the missing-weights error, the
weight converter, and the metrics CLI with a weights file."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gs_tpu_torch.apps import metrics as metrics_app
from gs_tpu_torch.ops import lpips as T

from utils import lpips_random_weights

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "lpips_taps.npz")
TAP_STRIDES = (7, 3, 5)   # tests/golden/gen_lpips_fixture.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_weights(seed: int) -> dict:
    """tests/utils.py::lpips_random_weights on the port's layout constants,
    so the fixture test runs without importing the JAX package."""
    rng = np.random.default_rng(seed)
    arrays, cin, conv_idx = {}, 3, 0
    for c in T.VGG16_CFG:
        if c == "M":
            continue
        arrays[f"conv{conv_idx}_w"] = rng.normal(
            0, 0.05, (c, cin, 3, 3)).astype(np.float32)
        arrays[f"conv{conv_idx}_b"] = rng.normal(0, 0.05, (c,)).astype(
            np.float32)
        cin = c
        conv_idx += 1
    for i, nc in enumerate(T.TAP_CHANNELS):
        arrays[f"lin{i}"] = np.abs(rng.normal(0, 0.1, (1, nc))).astype(
            np.float32)
    return arrays


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "w.npz")
    np.savez(path, **random_weights(7))
    return path


def test_layout_constants_and_weights_match_jax():
    from gs_tpu.ops import lpips as L
    assert T.VGG16_CFG == L.VGG16_CFG and T.TAP_CHANNELS == L.TAP_CHANNELS
    np.testing.assert_array_equal(T.SHIFT, L.SHIFT)
    np.testing.assert_array_equal(T.SCALE, L.SCALE)
    ref = lpips_random_weights(7)
    got = random_weights(7)
    assert set(got) == set(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)


def test_lpips_matches_jax(weights_npz, monkeypatch):
    import jax.numpy as jnp
    from gs_tpu.ops import lpips as L
    rng = np.random.default_rng(11)
    img1 = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0, 1).astype(
        np.float32)
    want = float(L.lpips_vgg(weights_npz)(jnp.asarray(img1),
                                          jnp.asarray(img2)))
    # the default path: $GS_TPU_LPIPS_WEIGHTS, as in the JAX package
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", weights_npz)
    assert T.default_weights_path() == L.default_weights_path() == weights_npz
    f = T.lpips_vgg(device="cpu")
    a, b = torch.from_numpy(img1), torch.from_numpy(img2)
    got = f(a, b)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-4, abs=1e-6)
    assert float(f(a, a)) == pytest.approx(0.0, abs=1e-8)


def test_lpips_tap_fixture():
    """Every normalized tap (strided slices, as committed) at rtol 2e-4 and
    atol 2e-5, and the value at rel 1e-4, abs 1e-6 (tests/test_lpips.py::
    test_lpips_tap_fixture), with no JAX in the loop."""
    fx = np.load(FIXTURE)
    f = T.LPIPS(random_weights(int(fx["seed"])), device="cpu")
    img1, img2 = torch.from_numpy(fx["img1"]), torch.from_numpy(fx["img2"])
    assert float(f(img1, img2)) == pytest.approx(float(fx["value"]),
                                                 rel=1e-4, abs=1e-6)
    cs, ys, xs = TAP_STRIDES
    with torch.no_grad():
        for img, suffix in ((img1, "a"), (img2, "b")):
            taps = f.features(f.z_score(img))
            assert [t.shape[1] for t in taps] == T.TAP_CHANNELS
            for i, t in enumerate(taps):
                t = T.normalize_act(t).numpy()[0, ::cs, ::ys, ::xs]
                np.testing.assert_allclose(
                    t, fx[f"tap{i}_{suffix}"], rtol=2e-4, atol=2e-5,
                    err_msg=f"tap {i} image {suffix}")


def test_lpips_missing_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        T.lpips_vgg(str(tmp_path / "absent.npz"), device="cpu")


def test_convert_torch_weights_cli(tmp_path, capsys):
    """tests/test_lpips.py::test_convert_torch_weights_cli: torchvision's
    vgg16 feature indices and richzhang's lin-head keys land on the npz
    layout exactly; --check then scores a pair on the CPU."""
    from gs_tpu_torch.apps.convert_lpips import main as conv_main
    weights = random_weights(7)
    conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {}
    for ci, ti in enumerate(conv_ids):
        vgg[f"features.{ti}.weight"] = torch.from_numpy(weights[f"conv{ci}_w"])
        vgg[f"features.{ti}.bias"] = torch.from_numpy(weights[f"conv{ci}_b"])
    lin = {f"lin{i}.model.1.weight":
           torch.from_numpy(weights[f"lin{i}"][:, :, None, None])
           for i in range(5)}
    vp, lp = tmp_path / "vgg16.pth", tmp_path / "vgg.pth"
    torch.save(vgg, vp)
    torch.save(lin, lp)
    out = tmp_path / "lpips.npz"
    conv_main(["--vgg", str(vp), "--lin", str(lp), "-o", str(out),
               "--check", "--data_device", "cpu"])
    loaded = np.load(out)
    assert set(loaded.files) == set(weights)
    for k, v in weights.items():
        np.testing.assert_array_equal(loaded[k], v)
    text = capsys.readouterr().out
    assert "self-check: lpips(random pair) =" in text
    assert "identical pair = 0.00e+00" in text


def test_metrics_cli_reports_lpips(weights_npz, tmp_path, monkeypatch,
                                   capsys):
    """With a weights file the metrics CLI adds LPIPS to results.json and
    per_view.json: the mean of the module's value over the views."""
    rng = np.random.default_rng(5)
    model = tmp_path / "model"
    pairs = []
    for sub in ("renders", "gt"):
        os.makedirs(model / "test" / "ours_3" / sub)
    for name in ("00000.png", "00001.png"):
        r = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        g = np.clip(r.astype(int) + rng.integers(-20, 20, r.shape), 0,
                    255).astype(np.uint8)
        Image.fromarray(r).save(model / "test" / "ours_3" / "renders" / name)
        Image.fromarray(g).save(model / "test" / "ours_3" / "gt" / name)
        pairs.append((r, g))
    monkeypatch.setenv("GS_TPU_LPIPS_WEIGHTS", weights_npz)
    metrics_app.main(["-m", str(model), "--data_device", "cpu"])
    assert "LPIPS unavailable" not in capsys.readouterr().out
    with open(model / "results.json") as f:
        entry = json.load(f)["ours_3"]
    with open(model / "per_view.json") as f:
        views = json.load(f)["ours_3"]
    f = T.lpips_vgg(weights_npz, device="cpu")

    def chw(x):
        return torch.from_numpy(x.astype(np.float32).transpose(2, 0, 1)
                                / 255.0)

    want = [float(f(chw(r), chw(g))) for r, g in pairs]
    assert set(views) == {"SSIM", "PSNR", "LPIPS"}
    assert list(views["LPIPS"].values()) == pytest.approx(want, rel=1e-6)
    assert entry["LPIPS"] == pytest.approx(np.mean(want), rel=1e-6)
    assert np.isfinite(entry["LPIPS"]) and entry["LPIPS"] > 0
