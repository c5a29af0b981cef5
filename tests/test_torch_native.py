"""The port's native image decoder (``peekvit_torch.native``) against the JAX
package's (``peekvit_tpu.native``), after tests/test_native.py's seven
cases: ``decode_transform``, ``decode`` and ``load_batch`` bit-equal to
JAX's, and within JAX's bounds of the PIL path (mean |diff| 0.1, 95th
percentile 0.35 in normalized units; 0.02 for the lossless crop case;
0.25 for pure-noise JPEGs under the scaled DCT); the ``ImageFolder`` and
``DataLoader`` paths bit-equal to JAX's. Then a forced build failure: every
call site gives the PIL path's samples and batches. The images are made
with PIL here; a case that needs a decoder skips where it cannot build."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from peekvit_tpu import native as jax_native
from peekvit_tpu.data import transforms as JT
from peekvit_tpu.data.datasets import ImageFolder as JaxImageFolder
from peekvit_tpu.data.loader import DataLoader as JaxDataLoader
from peekvit_torch import native
from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import ImageFolder
from peekvit_torch.data.loader import DataLoader

MEAN, STD = T.IMAGENET_MEAN, T.IMAGENET_STD


@pytest.fixture
def both():
    """Skip unless both decoders build here (decided in the test)."""
    if not native.available():
        pytest.skip(f"the port's native decoder did not build: {native.build_error()}")
    if not jax_native.available():
        pytest.skip(f"JAX's native decoder did not build: {jax_native.build_error()}")


def _jpeg_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "PNG")
    return buf.getvalue()


def _rand_img(h=90, w=120, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _smooth_img(h=90, w=120, seed=0):
    """Smooth gradients: the content the scaled DCT decode is close on."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        a, b, ph = rng.uniform(0.5, 2.0, 3)
        img[..., c] = (127 + 60 * np.sin(a * 2 * np.pi * yy / h + ph)
                       + 50 * np.cos(b * 2 * np.pi * xx / w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_eval(data, resize, size, normalize=True):
    pil = Image.open(io.BytesIO(data)).convert("RGB")
    ts = [T.Resize(resize), T.CenterCrop(size), T.ToArray()] + ([T.Normalize()] if normalize
                                                                 else [])
    return T.Compose(ts)(pil)


def _decode_both(data, resize, size, mean=MEAN, std=STD):
    got = native.decode_transform(data, resize, size, mean, std)
    want = jax_native.decode_transform(data, resize, size, mean, std)
    assert got is not None and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)
    return got


def _assert_pil_bounds(got, want, mean_bound=0.1, q95_bound=0.35):
    diff = np.abs(got - want)
    assert np.mean(diff) < mean_bound, f"mean abs diff {np.mean(diff)}"
    assert np.quantile(diff, 0.95) < q95_bound


@pytest.mark.parametrize("codec", [_jpeg_bytes, _png_bytes])
def test_decode_transform_matches_jax_and_pil(both, codec):
    data = codec(_rand_img())
    got = _decode_both(data, 32, 32)
    _assert_pil_bounds(got, _pil_eval(data, 32, 32))


def test_center_crop_semantics(both):
    """Resize to 48, center-crop 32 on a lossless PNG: PIL's integer box."""
    data = _png_bytes(_rand_img(64, 64, seed=1))
    got = _decode_both(data, 48, 32, [0, 0, 0], [1, 1, 1])
    assert np.mean(np.abs(got - _pil_eval(data, 48, 32, normalize=False))) < 0.02


def test_load_batch_threads(both, tmp_path):
    paths = []
    for i in range(10):
        p = tmp_path / f"img_{i}.jpg"
        p.write_bytes(_jpeg_bytes(_rand_img(seed=i)))
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.jpg"))  # flagged, not fatal
    batch, ok = native.load_batch(paths, 32, 32, MEAN, STD, num_threads=4)
    want, want_ok = jax_native.load_batch(paths, 32, 32, MEAN, STD, num_threads=4)
    assert batch.shape == (11, 32, 32, 3)
    assert ok[:10].all() and not ok[10]
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(batch[:10], want[:10])
    with open(paths[3], "rb") as f:
        np.testing.assert_array_equal(batch[3], native.decode_transform(f.read(), 32, 32,
                                                                        MEAN, STD))


def test_corrupt_input_rejected(both):
    assert native.decode_transform(b"not an image", 32, 32, MEAN, STD) is None
    assert native.decode(b"not an image") is None
    _, ok = native.load_batch([os.devnull], 32, 32, MEAN, STD)
    assert not ok[0]


def _folder(root, n, make, name="c"):
    d = root / name
    d.mkdir()
    for i in range(n):
        Image.fromarray(make(i), "RGB").save(d / f"{i}.jpg", quality=95)


def test_image_folder_native_path(both, tmp_path):
    """ImageFolder with the eval recipe decodes natively, bit-equal to JAX's
    native path and close to the PIL path."""
    _folder(tmp_path, 3, lambda i: _smooth_img(seed=20 + i), "cls_a")
    ds, jds = ImageFolder(tmp_path, T.test_transform(32)), JaxImageFolder(tmp_path,
                                                                          JT.test_transform(32))
    x, y = ds[0]
    assert ds._native_spec not in (None, False) and y == 0 and x.shape == (32, 32, 3)
    np.testing.assert_array_equal(x, jds[0][0])
    pil = ImageFolder(tmp_path, T.test_transform(32))
    pil._native_spec = False
    assert np.mean(np.abs(x - pil[0][0])) < 0.05
    batch, labels = ds.native_batch([2, 0])
    want, want_labels = jds.native_batch([2, 0])
    np.testing.assert_array_equal(batch, want)
    np.testing.assert_array_equal(labels, want_labels)


def test_dataloader_native_batch_path(both, tmp_path):
    """The loader's whole-batch path: JAX's batches bit for bit (int32
    labels), the per-item path's, and a deterministic shuffle."""
    _folder(tmp_path, 9, lambda i: _rand_img(seed=40 + i))
    ds, jds = ImageFolder(tmp_path, T.test_transform(32)), JaxImageFolder(tmp_path,
                                                                          JT.test_transform(32))
    batches = list(DataLoader(ds, 4, num_workers=2))
    assert [b[0].shape[0] for b in batches] == [4, 4, 1]
    for (x, y), (jx, jy) in zip(batches, JaxDataLoader(jds, 4, num_workers=2)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert y.dtype == jy.dtype == np.int32
    np.testing.assert_array_equal(batches[0][0], np.stack([ds[i][0] for i in range(4)]))
    loader = DataLoader(ds, 4, shuffle=True, num_workers=2, seed=3)
    for (_, a), (_, b) in zip(list(loader), list(loader)):
        np.testing.assert_array_equal(a, b)


def test_scaled_dct_decode_parity(both):
    """The M/8 scaled JPEG decode at the eval geometry (375x500 -> 256 ->
    224): bit-equal to JAX's, within the PIL bounds on smooth content and
    the looser noise bound on noise; the raw decode stays full size."""
    data = _jpeg_bytes(_smooth_img(375, 500, seed=7))
    _assert_pil_bounds(_decode_both(data, 256, 224), _pil_eval(data, 256, 224))
    raw = native.decode(data)
    assert raw is not None and raw.shape == (375, 500, 3)
    np.testing.assert_array_equal(raw, jax_native.decode(data))
    ndata = _jpeg_bytes(_rand_img(375, 500, seed=8))
    assert np.mean(np.abs(_decode_both(ndata, 256, 224) - _pil_eval(ndata, 256, 224))) < 0.25


@pytest.mark.parametrize("fault", ["no_compiler", "unwritable_build_dir"])
def test_failed_build_falls_back_to_pil(monkeypatch, tmp_path, fault):
    """A compiler that is not there, or a build directory that cannot be
    made (its parent is a file): available() is False, build_error() a
    string, no temporary file is left, and each call site gives the PIL
    path's samples (JAX's with its native path off): ImageFolder per
    image, native_batch declines, the loader's batches."""
    build = tmp_path / "build"
    if fault == "no_compiler":
        monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-g++"))
        monkeypatch.setattr(native, "BUILD_DIR", str(build))
        said = "no-such-g++"
    else:
        (tmp_path / "file").write_bytes(b"")
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "file" / "build"))
        said = "Not a directory"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert isinstance(native.build_error(), str) and said in native.build_error()
    assert not build.exists() or not any(".tmp" in f.name for f in build.iterdir())
    assert native.decode_transform(b"", 32, 32, MEAN, STD) is None
    assert native.load_batch(["x.jpg"], 32, 32, MEAN, STD) == (None, None)
    root = tmp_path / "images"
    root.mkdir()
    _folder(root, 5, lambda i: _smooth_img(40, 50, seed=60 + i))
    ds, jds = ImageFolder(root, T.test_transform(16)), JaxImageFolder(root, JT.test_transform(16))
    jds._native_spec = False
    for i in range(len(jds)):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
    assert ds._native_spec is False and ds.native_batch([0, 1]) is None
    got = list(DataLoader(ds, 2, num_workers=2))
    want = list(JaxDataLoader(jds, 2, num_workers=2))
    assert len(got) == len(want) == 3
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
