"""The port's nu-A2D data pipeline against the JAX package's, on the CPU.

The slice as a whole: on the JAX package's `data/synthetic.py::generate`
fixture, at 225x400 images with `AugConfig(H=225, W=400, final_dim=(32,
88))` (the defaults' ratios at a quarter of the width, where most training
crops reach past the resized image and resampling is real), the port's
loader gives the JAX loader's batches bit for bit, every key, images NCHW:
the train split seeded, with flips, epochs 0 and 1, two worker threads (and
process workers), and the val split. The CPU path runs the plain versions:
the Python entropy decoder, the plain IDCT and the plain resampling.

The pieces, each against the library the JAX package calls (PIL, OpenCV):
the plain JPEG decoder against PIL's decode on hypothesis-drawn images (odd
sizes, 4:4:4, 4:2:0 and gray, quality 50-100, restart intervals, optimised
Huffman tables), refusing what it does not decode; the encoder against
PIL's `save(quality)`, coefficients and bytes; the resampling against PIL's
`resize -> crop -> flip -> rotate` and `normalize_img` over hypothesis-drawn
augmentations, zero-filled crops included, and the rotation alone at 201
angles in +-5.4 degrees; `fill_poly` against `cv2.fillPoly` on rotated
rectangles inside and across the grid's edge; the port's `generate(seed)`
against JAX's, file by file; the augmentation's draws, the split tables and
the quaternion helpers. Everything bit for bit: no tolerance.

The Python entropy decoder takes about 0.1 s for a 225x400 image, so the
loader tests decode each of the fixture's 36 images once, and the tests
run torch on one thread (the suite's parallel workers share the cores);
the whole file takes about 17 s in one process."""
import functools
import io
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st
from PIL import Image

from lss2_multimodal_nu_tpu import config as jconfig
from lss2_multimodal_nu_tpu.core import augment as jaug
from lss2_multimodal_nu_tpu.data import dataset as jds, loader as jld, nuscenes_index as jni
from lss2_multimodal_nu_tpu.data import splits as jsplits, synthetic as jsyn
from lss2_multimodal_nu_tpu_torch import config as tconfig
from lss2_multimodal_nu_tpu_torch.core import augment as taug
from lss2_multimodal_nu_tpu_torch.core.augment import AugParams
from lss2_multimodal_nu_tpu_torch.data import dataset as tds, jpeg, loader as tld
from lss2_multimodal_nu_tpu_torch.data import nuscenes_index as tni, raster, splits as tsplits
from lss2_multimodal_nu_tpu_torch.data import synthetic as tsyn
from lss2_multimodal_nu_tpu_torch.ops import img_aug, jpeg_idct

H, W, FINAL = 225, 400, (32, 88)
AUG = dict(H=H, W=W, final_dim=FINAL, rand_flip=True)
KEYS = ("imgs", "rots", "trans", "intrins", "post_rots", "post_trans", "binimg", "act", "desc")
SETTINGS = settings(max_examples=30, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions' tensors here are small, and
    the suite runs in parallel workers that would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The JAX package's fixture: 2 mini_train scenes and 1 mini_val scene,
    2 samples each, 6 cameras at 225x400."""
    root = str(tmp_path_factory.mktemp("nu_a2d"))
    jsyn.generate(root, samples_per_scene=2, img_hw=(H, W), seed=3)
    return root


def _datasets(root, is_train):
    jd = jds.NuA2DDataset(jni.NuScenesIndex("v1.0-mini", root), is_train,
                          jconfig.AugConfig(**AUG), jconfig.GridConfig(), root, rng=7)
    td = tds.NuA2DDataset(tni.NuScenesIndex("v1.0-mini", root), is_train,
                          tconfig.AugConfig(**AUG), tconfig.GridConfig(), root, rng=7,
                          device="cpu")
    return jd, td


@pytest.fixture(scope="module")
def batches(fixture_root):
    """(JAX batches, port batches) per (split, epoch): B=2, two worker
    threads, the train split shuffled over epochs 0 and 1. Each file is
    entropy-decoded once (the decoder is a pure function of the file's
    bytes; epoch 1 reads epoch 0's files again)."""
    decode = functools.lru_cache(maxsize=None)(tds.decode_coefficients)
    mp = pytest.MonkeyPatch()
    mp.setattr(tds, "decode_coefficients", lambda data, library: decode(data, library))
    out = {}
    for split, epochs in (("train", 2), ("val", 1)):
        jd, td = _datasets(fixture_root, split == "train")
        jl = jld.DataLoader(jd, 2, shuffle=split == "train", num_workers=2)
        tl = tld.DataLoader(td, 2, shuffle=split == "train", num_workers=2)
        for epoch in range(epochs):
            out[(split, epoch)] = (list(jl), list(tl))
    mp.undo()
    return out


def _assert_batches_equal(jb, tb):
    assert len(jb) == len(tb) and len(jb) > 0
    for a, b in zip(jb, tb):
        assert set(a) == set(b) == set(KEYS)
        for k in KEYS:
            want = np.ascontiguousarray(a[k].transpose(0, 1, 4, 2, 3)) if k == "imgs" else a[k]
            got = b[k].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("split, epoch", [("train", 0), ("train", 1), ("val", 0)])
def test_loader_matches_jax(batches, split, epoch):
    """Every key of every batch, bit for bit (images NHWC -> NCHW)."""
    _assert_batches_equal(*batches[(split, epoch)])


def test_epochs_draw_new_augmentations(batches):
    """The train split's epochs differ (order and draws); the labels of one
    sample do not."""
    (_, e0), (_, e1) = batches[("train", 0)], batches[("train", 1)]
    assert not torch.equal(e0[0]["imgs"], e1[0]["imgs"])
    assert not torch.equal(e0[0]["post_rots"], e1[0]["post_rots"])


def test_process_workers_match_threads(fixture_root, batches):
    """A process worker (forkserver) gives the thread workers' batches."""
    _, td = _datasets(fixture_root, False)
    got = list(tld.DataLoader(td, 2, shuffle=False, num_workers=1, worker_type="process"))
    _assert_batches_equal(batches[("val", 0)][0], got)


def test_dataset_item_matches_the_loader(fixture_root, batches):
    """`dataset[i]` runs both stages on one item: the val loader's first
    batch holds items 0 and 1."""
    _, td = _datasets(fixture_root, False)
    item, first = td[1], batches[("val", 0)][1][0]
    assert item["imgs"].shape == (6, 3, *FINAL)
    for k in KEYS:
        assert torch.equal(item[k], first[k][1]), k


@pytest.mark.parametrize("prefetch", [1, 2])
def test_loader_bounds_the_items_in_flight(monkeypatch, prefetch):
    """Over an epoch of 12 batches read by a slow consumer, at most
    (prefetch + 2) * B host items are alive at once: the workers run a
    bounded number of batches ahead, and a collated batch's items are
    dropped. The batches still come in the index order."""
    b, nb = 3, 12
    lock, live, peak = threading.Lock(), [0], [0]

    class Item(dict):
        def __init__(self, i):
            super().__init__(index=i)
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])

        def __del__(self):
            with lock:
                live[0] -= 1

    class Stub:
        device = torch.device("cpu")
        aug = tconfig.AugConfig()

        def __len__(self):
            return b * nb

        def host_item(self, i):
            return Item(i)

    monkeypatch.setattr(tld, "collate", lambda items, final_dim, pin: [it["index"] for it in items])
    got = []
    for batch in tld.DataLoader(Stub(), b, shuffle=True, num_workers=4,
                                prefetch=prefetch).host_batches():
        time.sleep(0.005)
        got.extend(batch)
    assert got == list(tld.DataLoader(Stub(), b, shuffle=True)._indices())
    assert 0 < peak[0] <= (prefetch + 2) * b, peak[0]


def test_binimg_matches_jax_on_every_sample(fixture_root):
    """`get_binimg` (OpenCV's polygon fill for the vehicles) on every sample
    of both splits; the fixture has vehicles in every one."""
    for is_train in (True, False):
        jd, td = _datasets(fixture_root, is_train)
        for jrec, trec in zip(jd.ixes, td.ixes):
            want, got = jd.get_binimg(jrec), td.get_binimg(trec)
            assert (want == 1).sum() > 0
            np.testing.assert_array_equal(got, want)


def test_fixture_jpegs_decode_as_pil_does(fixture_root):
    """One sample's six camera JPEGs: the plain decoder (Python entropy
    decoding, plain IDCT) against PIL's RGB."""
    d = os.path.join(fixture_root, "samples")
    files = sorted(os.path.join(d, cam, f) for cam in os.listdir(d) if cam.startswith("CAM")
                   for f in os.listdir(os.path.join(d, cam)))[::6]
    assert len(files) == 6
    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        coefs = jpeg.decode_coefficients(data, library=False)
        packed = jpeg_idct.pack([coefs])
        got = jpeg_idct.decode(*map(torch.from_numpy, packed[:3]), H, W)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(Image.open(path)), err_msg=path)


# ---- the JPEG codec

def _pil_jpeg(img, quality, subsampling):
    buf = io.BytesIO()
    kw = {} if img.ndim == 2 else dict(subsampling=subsampling)
    Image.fromarray(img).save(buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def _decode_plain(data):
    c = jpeg.decode_coefficients(data, library=False)
    return jpeg_idct.decode(*map(torch.from_numpy, jpeg_idct.pack([c])[:3]), c.height,
                            c.width)[0].numpy()


@SETTINGS
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(50, 100),
       kind=st.sampled_from(["420", "444", "gray"]), restart=st.integers(0, 4),
       optimize=st.booleans(), seed=st.integers(0, 2**16))
def test_plain_decoder_matches_pil(h, w, quality, kind, restart, optimize, seed):
    """The plain decoder against PIL's decode: PIL writes the files without
    a restart interval, OpenCV with one (and with optimised Huffman tables
    where drawn)."""
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(128, 60, (h, w) if kind == "gray" else (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    if restart or optimize:
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                  cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
        if kind == "444":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        assert jpeg.parse(data).restart_interval == restart
    else:
        data = _pil_jpeg(img, quality, 0 if kind == "444" else 2)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(_decode_plain(data), want)


@SETTINGS
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(50, 100),
       seed=st.integers(0, 2**16))
def test_encoder_matches_pil(h, w, quality, seed):
    """`encode` writes PIL's `save(quality=q)` file byte for byte; its
    coefficients (dummy blocks included) are those PIL's file holds."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = _pil_jpeg(img, quality, 2)
    got = jpeg.encode(img, quality)
    np.testing.assert_array_equal(jpeg.encode_coefficients(img, quality).coefs,
                                  jpeg.decode_coefficients(want, library=False).coefs)
    assert got == want


@pytest.mark.parametrize("kind", ["progressive", "422", "truncated", "not a jpeg"])
def test_decoder_refuses_what_it_does_not_decode(kind):
    img = np.random.default_rng(1).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    buf = io.BytesIO()
    if kind == "progressive":
        Image.fromarray(img).save(buf, format="JPEG", progressive=True)
    elif kind == "422":
        Image.fromarray(img).save(buf, format="JPEG", subsampling=1)
    else:
        Image.fromarray(img).save(buf, format="JPEG", quality=95)
    data = buf.getvalue()
    if kind == "truncated":
        data = data[:len(data) // 2]
    elif kind == "not a jpeg":
        data = b"\x89PNG" + data[4:]
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_coefficients(data, library=False)


# ---- the augmentation's resampling

def _pil_augment(img, p):
    out, _, _ = jds.img_transform(Image.fromarray(img), p)
    return np.ascontiguousarray(jds.normalize_img(out).transpose(2, 0, 1))


def _plain_augment(img, p, final_dim):
    params, htab, vtab, rows = img_aug.plan([p], img.shape[0], img.shape[1], final_dim)
    return img_aug.augment(torch.from_numpy(img)[None],
                           *map(torch.from_numpy, (params, htab, vtab)), final_dim,
                           rows)[0].numpy()


@SETTINGS
@given(h=st.integers(16, 120), w=st.integers(16, 200), fh=st.integers(4, 40),
       fw=st.integers(4, 96), resize=st.floats(0.1, 1.5), is_train=st.booleans(),
       seed=st.integers(0, 2**16))
def test_resampling_matches_pil(h, w, fh, fw, resize, is_train, seed):
    """resize -> crop -> flip -> rotate -> normalize against PIL and the JAX
    package's `normalize_img`, with the augmentation drawn as the dataset
    draws it around a drawn scale (crops past the resized image zero-fill)."""
    conf = tconfig.AugConfig(H=h, W=w, final_dim=(fh, fw), resize_lim=(resize, resize * 1.2),
                             rand_flip=True)
    p = taug.sample_augmentation(conf, is_train, np.random.default_rng(seed))
    if min(p.resize_dims) < 1:
        return  # PIL refuses a resize to nothing
    img = np.random.default_rng(seed + 1).integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_plain_augment(img, p, (fh, fw)), _pil_augment(img, p))


def test_training_crops_reach_past_the_image():
    """At the defaults' ratios most training crops reach past the resized
    width (zero fill, normalised to -mean/std), and those pixels match PIL."""
    conf = tconfig.AugConfig(**AUG)
    rng = np.random.default_rng(0)
    draws = [taug.sample_augmentation(conf, True, rng) for _ in range(200)]
    short = [p for p in draws if p.resize_dims[0] < FINAL[1]]
    assert len(short) > 100
    img = np.random.default_rng(1).integers(0, 256, (H, W, 3), dtype=np.uint8)
    p = AugParams(short[0].resize, short[0].resize_dims, short[0].crop, False, 0.0)
    got = _plain_augment(img, p, FINAL)
    np.testing.assert_array_equal(got, _pil_augment(img, p))
    fill = (-np.array(img_aug.IMAGENET_MEAN, np.float32) / np.array(img_aug.IMAGENET_STD,
                                                                      np.float32))
    edge = p.resize_dims[0] - p.crop[0]
    np.testing.assert_array_equal(got[:, :, edge:], np.broadcast_to(
        fill[:, None, None], got[:, :, edge:].shape))


def test_rotation_matches_pil_at_many_angles():
    """PIL's `rotate` alone (the resize to the image's own size and the full
    crop are copies): 201 angles in +-5.4 degrees, 0.0 and -0.0 among them,
    with and without the flip. PIL maps in 16.16 fixed point."""
    img = np.random.default_rng(2).integers(0, 256, (*FINAL, 3), dtype=np.uint8)
    angles = list(np.linspace(-5.4, 5.4, 199)) + [0.0, -0.0]
    for i, angle in enumerate(angles):
        p = AugParams(1.0, (FINAL[1], FINAL[0]), (0, 0, FINAL[1], FINAL[0]), i % 2 == 1,
                      float(angle))
        np.testing.assert_array_equal(_plain_augment(img, p, FINAL), _pil_augment(img, p),
                                      err_msg=str(angle))
    assert img_aug.rotate_fixed(0.0, 88, 32) is None and img_aug.rotate_fixed(-0.0, 88, 32) is None


# ---- OpenCV's polygon fill

@SETTINGS
@given(cx=st.floats(-20, 220), cy=st.floats(-20, 220), length=st.floats(0.5, 30),
       width=st.floats(0.5, 12), yaw=st.floats(0, 2 * np.pi))
def test_fill_poly_matches_cv2(cx, cy, length, width, yaw):
    """Rotated rectangles on the 200x200 BEV grid, inside it and across its
    edges, as `get_binimg` rasterises the vehicles: `cv2.fillPoly` exactly."""
    c, s = np.cos(yaw), np.sin(yaw)
    corners = np.array([[length, width], [length, -width], [-length, -width],
                        [-length, width]]) / 2
    pts = np.round(corners @ np.array([[c, s], [-s, c]]) + [cx, cy]).astype(np.int32)
    want, got = np.zeros((200, 200)), np.zeros((200, 200))
    cv2.fillPoly(want, [pts], 1.0)
    raster.fill_poly(got, pts, 1.0)
    np.testing.assert_array_equal(got, want)


def test_fill_poly_matches_cv2_on_polygons():
    """Random polygons of 3-6 vertices, self-intersecting ones among them,
    some reaching past the image."""
    rng = np.random.default_rng(4)
    for _ in range(300):
        n = int(rng.choice([40, 200]))
        pts = rng.integers(-10, n + 10, (int(rng.integers(3, 7)), 2)).astype(np.int32)
        want, got = np.zeros((n, n)), np.zeros((n, n))
        cv2.fillPoly(want, [pts], 1.0)
        raster.fill_poly(got, pts, 1.0)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


# ---- the fixture generator, the draws, the tables

def test_generate_matches_jax(tmp_path):
    """The port's `generate(seed)` against JAX's at their defaults: every
    file, JSON tables and sidecars byte for byte, each JPEG byte for byte
    and as quantised coefficients; with two worker processes the same."""
    roots = {k: str(tmp_path / k) for k in ("jax", "port", "workers")}
    jsyn.generate(roots["jax"], seed=11)
    tsyn.generate(roots["port"], seed=11)
    tsyn.generate(roots["workers"], seed=11, workers=2)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(roots["jax"])
    assert sum(n.endswith(".jpg") for n in names) == 36 and any(n.endswith(".npy") for n in names)
    assert files(roots["port"]) == files(roots["workers"]) == names
    for name in names:
        want = open(os.path.join(roots["jax"], name), "rb").read()
        for k in ("port", "workers"):
            got = open(os.path.join(roots[k], name), "rb").read()
            if name.endswith(".jpg"):
                np.testing.assert_array_equal(jpeg.decode_coefficients(got, library=False).coefs,
                                              jpeg.decode_coefficients(want, library=False).coefs)
            assert got == want, (k, name)


def test_augmentation_draws_match_jax():
    """`sample_augmentation` and the affine bookkeeping draw and compute as
    JAX's, train and eval; with `rand_flip` off no flip is drawn at all (the
    generators end in the same state)."""
    for flip in (True, False):
        jc = jconfig.AugConfig(rand_flip=flip)
        tc = tconfig.AugConfig(rand_flip=flip)
        for seed in range(50):
            for is_train in (True, False):
                jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
                jp, tp = jaug.sample_augmentation(jc, is_train, jr), taug.sample_augmentation(
                    tc, is_train, tr)
                assert tuple(jp.__dict__.values()) == tuple(tp.__dict__.values())
                assert jr.random() == tr.random()
                for a, b in zip(jaug.expand_to_3x3(*jaug.accumulate_post_transform(jp)),
                                taug.expand_to_3x3(*taug.accumulate_post_transform(tp))):
                    np.testing.assert_array_equal(a, b)
    rng, ref = np.random.default_rng(0), np.random.default_rng(0)
    assert not taug.sample_augmentation(tconfig.AugConfig(rand_flip=False), True, rng).flip
    ref.uniform(size=4)  # resize, bottom cut, crop, rotation: four doubles, no flip
    assert rng.random() == ref.random()


def test_splits_and_index_helpers_match_jax():
    """Both split families as JAX has them (their mismatch kept), and the
    quaternion and box helpers bit for bit."""
    for family in ("nu_a2d", "nuscenes_full"):
        assert tsplits.create_splits_scenes(family) == jsplits.create_splits_scenes(family)
    a, b = tsplits.create_splits_scenes("nu_a2d"), tsplits.create_splits_scenes("nuscenes_full")
    assert a["train"] != b["train"]
    rng = np.random.default_rng(5)
    for _ in range(20):
        q, r = rng.normal(size=4), rng.normal(size=4)
        for name in ("quaternion_rotation_matrix", "quaternion_inverse"):
            np.testing.assert_array_equal(getattr(tni, name)(q), getattr(jni, name)(q))
        np.testing.assert_array_equal(tni.quaternion_multiply(q, r), jni.quaternion_multiply(q, r))
        c, size = rng.normal(size=3), rng.uniform(1, 5, 3)
        np.testing.assert_array_equal(tni.box_bottom_corners(c, size, q),
                                      jni.box_bottom_corners(c, size, q))


def test_bindings_match_the_c_entry_points():
    """Each ctypes binding of the data slice's libraries names as many
    arguments as its `extern "C"` entry point in `csrc/` takes (ctypes would
    refuse a call otherwise, and only on the card)."""
    import re
    from pathlib import Path

    csrc = Path(jpeg_idct.__file__).resolve().parent.parent / "csrc"
    for source, symbol, argtypes in (
            ("jpeg_idct.cu", "jpeg_idct_decode", jpeg_idct._ARGTYPES),
            ("img_aug.cu", "img_aug_forward", img_aug._ARGTYPES),
            ("jpeg_entropy.cu", "lss_jpeg_entropy_decode", jpeg._C_ARGTYPES)):
        text = (csrc / source).read_text()
        m = re.search(r"\bint " + symbol + r"\(([^)]*)\)", text)
        assert m, symbol
        assert len(m.group(1).split(",")) == len(argtypes), symbol


def test_entropy_decoder_source_matches_python(tmp_path, monkeypatch):
    """`csrc/jpeg_entropy.cu` is host code only: built here by the host's
    C++ compiler, it decodes as the Python decoder does on PIL's and
    OpenCV's files (4:2:0, 4:4:4, gray, restart intervals, optimised
    tables), and refuses a truncated scan. On the card it is built by nvcc
    with the kernels and held to the Python decoder again
    (`test_torch_kernels_cuda.py`)."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = Path(jpeg.__file__).resolve().parent.parent / "csrc" / "jpeg_entropy.cu"
    lib_path = tmp_path / "libjpeg_entropy.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++", str(src), "-o",
                    str(lib_path)], check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    fn, msg = lib.lss_jpeg_entropy_decode, lib.lss_jpeg_error_string
    fn.argtypes, fn.restype = jpeg._C_ARGTYPES, ctypes.c_int
    msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
    monkeypatch.setattr(jpeg, "_c_decoder", lambda: (fn, msg))
    rng = np.random.default_rng(8)
    for h, w in ((1, 1), (17, 23), (90, 160), (225, 400)):
        for kind in ("420", "444", "gray"):
            img = np.clip(rng.normal(128, 60, (h, w) if kind == "gray" else (h, w, 3)), 0, 255)
            img = img.astype(np.uint8)
            files = [_pil_jpeg(img, int(rng.integers(50, 101)), 0 if kind == "444" else 2)]
            params = [cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.integers(1, 5)),
                      cv2.IMWRITE_JPEG_OPTIMIZE, 1]
            if kind == "444":
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
            files.append(cv2.imencode(".jpg", img, params)[1].tobytes())
            for data in files:
                np.testing.assert_array_equal(jpeg.decode_coefficients(data, library=True).coefs,
                                              jpeg.decode_coefficients(data, library=False).coefs)
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_coefficients(files[0][:len(files[0]) // 2] + b"\xff\xd9", library=True)
