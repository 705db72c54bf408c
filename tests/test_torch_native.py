"""The port's native host code (``mpreid_tpu_torch/native/``) against the
JAX package's (``mpreid_tpu/native/``) and against Pillow.

Images come from numpy seeds, written by Pillow as JPEG or PNG files (or
held in memory for the resize) and go through the JAX function and its
counterpart in the port: every image byte for byte. The batcher's batches
under each value of ``DATALOADER.NATIVE_DECODE`` equal the JAX batcher's,
byte for byte, with the decoded-image cache on and off. Re-ranked distances:
the port's native re-ranker within 1e-5 max abs of the JAX package's, and
within 1e-4 of the port's dense ``ops/reranking.py`` on the CPU (the
tolerance of tests/test_native.py against its NumPy oracle).

The tests skip where this host cannot build the libraries (no g++, OpenMP,
libjpeg or libpng headers) or where the decoder fails its self-check
against Pillow; that is decided inside a fixture, not at import.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mpreid_tpu.data.loader import ImageBatcher as JaxImageBatcher
from mpreid_tpu.data.loader import make_dataloader as jax_make_dataloader
from mpreid_tpu.native import decode_resize_batch_native as jax_decode_batch
from mpreid_tpu.native import native_available as jax_rerank_available
from mpreid_tpu.native import re_ranking_native as jax_re_ranking_native
from mpreid_tpu.native import resize_rgb8_native as jax_resize
from mpreid_tpu.native.imageio import native_imageio_available as jax_imageio_available
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import ImageBatcher, build_dataset, decode_resize, make_dataloader
from mpreid_tpu_torch.data.synthetic import make_market1501
from mpreid_tpu_torch.engine.processor import build_device_dataset
from mpreid_tpu_torch.kernels.build import BUILD_DIR
from mpreid_tpu_torch.native import build as native_build
from mpreid_tpu_torch.native import imageio, rerank
from mpreid_tpu_torch.native import (
    decode_resize_batch_native, native_available, re_ranking_native, resize_rgb8_native,
)
from mpreid_tpu_torch.ops.reranking import re_ranking

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (48, 24)  # the batchers' target (h, w)


@pytest.fixture
def imageio_lib():
    if not (imageio.native_imageio_available() and jax_imageio_available()):
        pytest.skip(f"native imageio unavailable: {imageio.why_unavailable()}")


@pytest.fixture
def rerank_lib():
    if not (native_available() and jax_rerank_available()):
        pytest.skip(f"native rerank unavailable: {rerank.why_unavailable()}")


def _write(tmp_path, sizes, fmt="jpg", seed=7, prefix="img"):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"{prefix}_{i}.{fmt}")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# the library: build key, import, failures
# ---------------------------------------------------------------------------

def test_importing_the_package_builds_nothing():
    code = ("import mpreid_tpu_torch.native as n, mpreid_tpu_torch.data.loader\n"
            "print(n.imageio.LIBRARY._done, n.rerank.LIBRARY._done)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]


def test_the_build_key_holds_the_source_flags_and_cpu(monkeypatch):
    path = native_build.library_path("imageio", ("-ljpeg", "-lpng"))
    assert path.parent == BUILD_DIR and path.name.startswith("imageio-")
    assert native_build.library_path("imageio") != path  # the link flags
    monkeypatch.setattr(native_build, "cpu_identity", lambda: "another host's CPU")
    assert native_build.library_path("imageio", ("-ljpeg", "-lpng")) != path


def test_cpu_identity_names_the_cpu():
    ident = native_build.cpu_identity()
    assert ident and ident == native_build.cpu_identity()


def test_a_failed_build_is_unavailable_and_says_why(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    lib = native_build.NativeLibrary("broken")
    assert lib.get() is None
    assert lib.why.startswith(("g++ exited", "g++ not found")), lib.why
    assert not list((tmp_path / "_build").glob("*.so"))


def test_a_failed_check_is_unavailable_and_says_why(imageio_lib):
    lib = native_build.NativeLibrary("imageio", ("-ljpeg", "-lpng"), imageio._declare,
                                     check=lambda lib: "refused by the check")
    assert lib.get() is None and lib.why == "refused by the check"


def test_libraries_live_in_the_build_dir(imageio_lib, rerank_lib):
    for name, libs in (("imageio", ("-ljpeg", "-lpng")), ("rerank", ())):
        assert native_build.library_path(name, libs).exists()
    here = os.path.join(REPO, "mpreid_tpu_torch", "native")
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


# ---------------------------------------------------------------------------
# resize and batch decode, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [
    ((128, 64), (256, 128)),  # Market-1501's source size up to the train size
    ((70, 33), (256, 128)),
    ((256, 128), (128, 64)),
    ((70, 33), (13, 7)),
    ((37, 23), (24, 12)),
    ((33, 70), (70, 33)),
    ((5, 3), (64, 32)),
])
def test_resize_matches_jax_and_pillow(imageio_lib, in_hw, out_hw):
    img = np.random.RandomState(3).randint(0, 256, (*in_hw, 3), dtype=np.uint8)
    got = resize_rgb8_native(img, *out_hw)
    pil = np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BICUBIC),
                     np.uint8)
    np.testing.assert_array_equal(got, jax_resize(img, *out_hw))
    np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_batch_decode_matches_jax_and_decode_resize(imageio_lib, tmp_path, fmt):
    sizes = [(70, 33), (128, 64), (45, 90), (256, 128), (32, 16)]
    paths = _write(tmp_path, sizes, fmt)
    for hw in ((64, 32), (256, 128)):
        batch, status = decode_resize_batch_native(paths, hw)
        want, want_status = jax_decode_batch(paths, hw)
        assert status.tolist() == want_status.tolist() == [0] * len(paths)
        np.testing.assert_array_equal(batch, want)
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(batch[i], decode_resize(p, hw))


def test_failed_rows_are_flagged_and_zeroed(imageio_lib, tmp_path):
    good = _write(tmp_path, [(128, 64)])[0]
    data = open(good, "rb").read()
    missing = str(tmp_path / "missing.jpg")
    garbage = tmp_path / "garbage.jpg"
    garbage.write_bytes(b"not an image at all")
    head = tmp_path / "truncated_header.jpg"
    head.write_bytes(data[:len(data) // 20])
    scan = tmp_path / "truncated_scan.jpg"
    scan.write_bytes(data[:len(data) // 2])
    paths = [good, missing, str(garbage), str(head), str(scan)]
    batch, status = decode_resize_batch_native(paths, (64, 32))
    want, want_status = jax_decode_batch(paths, (64, 32))
    assert status.tolist() == want_status.tolist()
    np.testing.assert_array_equal(batch, want)
    assert status[0] == 0 and (status[1:4] != 0).all()
    assert not batch[1:4].any()
    # a file cut inside its scan decodes (libjpeg pads it), as Pillow does
    assert status[4] == 0
    for i in (0, 4):
        np.testing.assert_array_equal(batch[i], decode_resize(paths[i], (64, 32)))


def test_16bit_grayscale_png_is_refused_and_decoded_by_pillow(imageio_lib, tmp_path):
    arr = (np.linspace(0, 40000, 48 * 24).reshape(48, 24)).astype(np.int32)
    p = str(tmp_path / "gray16.png")
    Image.fromarray(arr, mode="I").save(p)
    _, status = decode_resize_batch_native([p], (32, 16))
    assert status[0] != 0 and status.tolist() == jax_decode_batch([p], (32, 16))[1].tolist()
    records = [(p, 0, 0, 0)]
    got = next(ImageBatcher(records, (32, 16), 1, native=True).iter_sequential())
    want = next(JaxImageBatcher(records, (32, 16), 1, native=False).iter_sequential())
    np.testing.assert_array_equal(got["images"], want["images"])


# ---------------------------------------------------------------------------
# the batcher under DATALOADER.NATIVE_DECODE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def market(tmp_path_factory):
    """A synthetic Market-1501 tree at its own 128×64 size, plus a garbage
    file and a truncated one among the train records."""
    root = tmp_path_factory.mktemp("native_market")
    make_market1501(str(root), n_ids=6, imgs_per_id=4, size=(128, 64), identity_signal=True)
    dataset = build_dataset("market1501", str(root))
    bad = root / "bad"
    bad.mkdir()
    (bad / "garbage.jpg").write_bytes(b"not an image at all")
    first = open(dataset.train[0][0], "rb").read()
    (bad / "cut.jpg").write_bytes(first[:len(first) // 20])
    records = list(dataset.train) + [(str(bad / "garbage.jpg"), 0, 0, 0),
                                     (str(bad / "cut.jpg"), 1, 1, 0)]
    return str(root), records


def _batches(batcher):
    return [(b["images"], b["pids"], b["camids"], b["count"])
            for b in batcher.iter_sequential()]


@pytest.mark.parametrize("cache", [False, True], ids=["cache_off", "cache_on"])
@pytest.mark.parametrize("native", ["auto", True, False])
def test_batcher_matches_jax(imageio_lib, market, native, cache):
    _, records = market
    got = ImageBatcher(records, SIZE, 5, num_workers=2, cache=cache, native=native)
    want = JaxImageBatcher(records, SIZE, 5, num_workers=2, cache=cache, native=native)
    assert got.native == bool(native) == want._native
    for _ in range(2):  # with the cache on, the second pass reads it
        for g, w in zip(_batches(got), _batches(want), strict=True):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    if cache:
        assert sorted(got._cache) == sorted(want._cache)
        for key, img in got._cache.items():
            np.testing.assert_array_equal(img, want._cache[key])


def test_both_paths_share_one_cache(imageio_lib, market, monkeypatch):
    """One cache dict, filled by the native path, serves the Pillow one (and
    the other way round) with the same bytes."""
    from mpreid_tpu_torch.data import loader

    _, records = market
    for first, second in ((True, False), (False, True)):
        shared = {}
        a = ImageBatcher(records, SIZE, 4, num_workers=2, cache=shared, native=first)
        filled = [b["images"] for b in a.iter_sequential()]
        assert len(shared) == len(records)
        b = ImageBatcher(records, SIZE, 4, num_workers=2, cache=shared, native=second)
        with monkeypatch.context() as m:  # any decode now fails: the cache serves
            m.setattr(loader, "decode_resize", None)
            m.setattr(imageio, "decode_resize_batch_native", None)
            served = [c["images"] for c in b.iter_sequential()]
        for x, y in zip(filled, served, strict=True):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("native", ["auto", True, False])
def test_decode_records_and_the_device_dataset_match_jax(imageio_lib, market, native):
    _, records = market
    got = ImageBatcher(records, SIZE, 8, num_workers=2, native=native)
    want = JaxImageBatcher(records, SIZE, 8, num_workers=2, native=native)
    np.testing.assert_array_equal(np.stack(got.decode_records(records)),
                                  np.stack(want.decode_records(records)))

    class Loader:
        batcher = got

    images, pids, camids, trackids = build_device_dataset(Loader, torch.device("cpu"))
    np.testing.assert_array_equal(images.numpy(), np.stack(want.decode_records(records)))
    assert pids.tolist() == [r[1] for r in records]


@pytest.mark.parametrize("native", ["auto", True, False])
def test_make_dataloader_passes_the_key_to_every_batcher(imageio_lib, market, native):
    root, _ = market
    cfg = get_default_cfg()
    cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR = "market1501", root
    cfg.INPUT.SIZE_TRAIN, cfg.INPUT.SIZE_TEST = list(SIZE), [32, 16]
    cfg.DATALOADER.SAMPLER, cfg.DATALOADER.NUM_INSTANCE = "softmax_triplet", 4
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.SOLVER.STAGE2.IMS_PER_BATCH = cfg.SOLVER.STAGE1.IMS_PER_BATCH = 8
    cfg.TEST.IMS_PER_BATCH = 16
    cfg.DATALOADER.NATIVE_DECODE = native
    got, want = make_dataloader(cfg), jax_make_dataloader(cfg)
    for g, w in ((got[0].batcher, want[0].batcher), (got[1].batcher, want[1].batcher),
                 (got[2], want[2])):
        assert g.native == bool(native) == w._native
    for a, b in zip(got[1].epoch(0), want[1].epoch(0), strict=True):  # stage 1's epoch
        np.testing.assert_array_equal(a["images"], b["images"])
    for a, b in zip(got[2].iter_sequential(), want[2].iter_sequential(), strict=True):
        np.testing.assert_array_equal(a["images"], b["images"])


def test_true_warns_and_uses_pillow_where_unavailable(market, monkeypatch, caplog):
    _, records = market
    off = native_build.NativeLibrary("imageio", ("-ljpeg", "-lpng"), imageio._declare,
                                     check=lambda lib: "refused by the check")
    monkeypatch.setattr(imageio, "LIBRARY", off)
    with caplog.at_level(logging.WARNING, logger="mpreid_tpu_torch.data"):
        auto = ImageBatcher(records[:4], SIZE, 4, native="auto")
        assert not caplog.records
        forced = ImageBatcher(records[:4], SIZE, 4, native=True)
    assert not auto.native and not forced.native
    assert len(caplog.records) == 1 and "refused by the check" in caplog.records[0].getMessage()
    want = JaxImageBatcher(records[:4], SIZE, 4, native=False)
    np.testing.assert_array_equal(next(forced.iter_sequential())["images"],
                                  next(want.iter_sequential())["images"])


# ---------------------------------------------------------------------------
# the native re-ranker
# ---------------------------------------------------------------------------

def clustered(seed=3, n_ids=8, nq=24, ng=56, dim=16):
    """tests/test_native.py's features."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_ids, dim) * 3
    qf = np.stack([centers[i % n_ids] + rng.randn(dim) * 0.5 for i in range(nq)])
    gf = np.stack([centers[i % n_ids] + rng.randn(dim) * 0.5 for i in range(ng)])
    return qf.astype(np.float32), gf.astype(np.float32)


@pytest.mark.parametrize("k1,k2", [(10, 4), (6, 1), (20, 6)])
def test_rerank_matches_jax_native(rerank_lib, k1, k2):
    qf, gf = clustered()
    got = re_ranking_native(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    want = jax_re_ranking_native(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    assert got.shape == want.shape == (24, 56) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k1,k2", [(10, 4), (6, 1), (20, 6)])
def test_rerank_matches_the_dense_port(rerank_lib, k1, k2):
    qf, gf = clustered(seed=5)
    got = re_ranking_native(qf, gf, k1=k1, k2=k2, lambda_value=0.3)
    dense = re_ranking(torch.from_numpy(qf), torch.from_numpy(gf), k1=k1, k2=k2,
                       lambda_value=0.3).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-4)


def test_rerank_clamps_a_small_gallery(rerank_lib):
    qf, gf = clustered(nq=4, ng=5)
    got = re_ranking_native(qf, gf, k1=50, k2=15)
    want = jax_re_ranking_native(qf, gf, k1=50, k2=15)
    assert got.shape == (4, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dense = re_ranking(torch.from_numpy(qf), torch.from_numpy(gf), k1=50, k2=15).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-4)
