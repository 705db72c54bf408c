"""Every config key the JAX package acts on is read by the port, or logged by it as doing nothing.

The sources of ``mpreid_tpu/`` and its four entry scripts are read as text
(nothing of them is imported) for every ``cfg.NODE.KEY`` and
``getattr(cfg.NODE, "KEY")``. Each such key must be read by the code of
a source of ``mpreid_tpu_torch/`` other than ``config/defaults.py`` (its
syntax tree, so docstrings and comments do not count: an attribute
``.KEY``, ``getattr(..., "KEY")`` or ``...["KEY"]``; the leaf alone, since
the port reads some keys through a node it was handed, as
``solver/schedules.py`` reads ``stage_cfg.BASE_LR``), or stand in
``engine/processor.py::INERT_KEYS``, the keys the port logs as doing
nothing, and not both; ``DATALOADER.NATIVE_DECODE`` is read, and picks
each batcher's decoder. ``TPU.REMAT`` and ``TPU.ASYNC_CHECKPOINT`` must
be read, not logged: a config that set either ran in the port as though it did not.
Each key of ``INERT_KEYS``, set, logs one line at the entry points' common
start (``train.py::start``), and nothing when left at its default.
"""

import ast
import logging
import re
from pathlib import Path

import pytest

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine.processor import INERT_KEYS
from mpreid_tpu_torch.train import start

REPO = Path(__file__).resolve().parents[1]
ENTRY_SCRIPTS = ("train.py", "test.py", "train_uniprompt.py", "test_uniprompt.py")
READ = re.compile(r"\bcfg\.([A-Z][A-Z0-9_]*)\.([A-Z][A-Z0-9_]*)\b")
GETATTR = re.compile(r"getattr\(\s*cfg\.([A-Z][A-Z0-9_]*)\s*,\s*[\"']([A-Z][A-Z0-9_]*)[\"']")


def _jax_keys():
    sources = sorted((REPO / "mpreid_tpu").rglob("*.py")) + [REPO / f for f in ENTRY_SCRIPTS]
    keys = set()
    for path in sources:
        text = path.read_text()
        keys |= set(READ.findall(text)) | set(GETATTR.findall(text))
    return sorted(keys)


def _port_reads_all() -> set:
    """Every upper-case name the port's code reads as an attribute, through
    ``getattr`` or as a constant subscript."""
    defaults = REPO / "mpreid_tpu_torch" / "config" / "defaults.py"
    names = set()
    for path in sorted((REPO / "mpreid_tpu_torch").rglob("*.py")):
        if path == defaults:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "getattr" \
                    and len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                names.add(node.args[1].value)
            elif isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant):
                names.add(node.slice.value)
    return {n for n in names if isinstance(n, str) and n.isupper()}


JAX_KEYS = _jax_keys()
PORT_READS = _port_reads_all()
INERT = {(node, key) for node, key, *_ in INERT_KEYS}


def test_the_scan_finds_the_keys_of_the_jax_package():
    assert len(JAX_KEYS) >= 70
    for key in [("TPU", "REMAT"), ("TPU", "ASYNC_CHECKPOINT"), ("TPU", "COMPILE_CACHE_DIR"),
                ("DATALOADER", "NATIVE_DECODE"), ("MODEL", "MOE")]:
        assert key in JAX_KEYS, key


@pytest.mark.parametrize("node,key", JAX_KEYS, ids=[f"{n}.{k}" for n, k in JAX_KEYS])
def test_the_port_reads_or_logs_each_key_of_the_jax_package(node, key):
    assert key in get_default_cfg()[node], f"{node}.{key} is not in the port's defaults"
    reads = key in PORT_READS
    assert reads or (node, key) in INERT, f"{node}.{key}: read nowhere in the port, and not logged"
    assert not (reads and (node, key) in INERT), f"{node}.{key}: read, and logged as doing nothing"


def test_remat_and_async_checkpoint_are_read_not_logged():
    for key in ("REMAT", "ASYNC_CHECKPOINT"):
        assert ("TPU", key) not in INERT and key in PORT_READS


def _start_logs(cfg, tmp_path) -> list:
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("mpreid_tpu_torch")
    handler = Keep()
    logger.addHandler(handler)
    try:
        start(cfg, str(tmp_path), if_train=False)
    finally:
        logger.removeHandler(handler)
    return [m for m in records if "does nothing in the port" in m]


@pytest.mark.parametrize("node,key,value", [("TPU", "COMPILE_CACHE_DIR", "xla_cache")])
def test_each_inert_key_logs_one_line_when_set(tmp_path, node, key, value):
    assert (node, key) in INERT
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg[node][key] = value
    lines = _start_logs(cfg, tmp_path)
    assert len(lines) == 1 and lines[0].startswith(f"{node}.{key} does nothing in the port")


def test_the_inert_keys_log_nothing_at_their_defaults(tmp_path):
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE = "cpu"
    assert _start_logs(cfg, tmp_path) == []
    cfg.merge_from_file(str(REPO / "configs" / "tpu" / "uniprompt_tuned.yml"))
    cfg.MODEL.DEVICE = "cpu"
    assert [m.split(" ")[0] for m in _start_logs(cfg, tmp_path)] == ["TPU.COMPILE_CACHE_DIR"]


@pytest.mark.parametrize("value", [True, False, "auto"])
def test_native_decode_picks_the_path_of_every_batcher(tmp_path, value):
    """``DATALOADER.NATIVE_DECODE`` is read, not logged: ``make_dataloader``
    hands it to the stage-2, stage-1 and val batchers, which take the native
    decoder under True and ``'auto'`` where it builds and self-checks, and
    Pillow under False."""
    from mpreid_tpu_torch.data import make_dataloader
    from mpreid_tpu_torch.data.synthetic import make_market1501
    from mpreid_tpu_torch.native.imageio import native_imageio_available

    assert ("DATALOADER", "NATIVE_DECODE") not in INERT and "NATIVE_DECODE" in PORT_READS
    make_market1501(str(tmp_path / "market"), n_ids=4, imgs_per_id=4)
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR = "market1501", str(tmp_path / "market")
    cfg.DATALOADER.SAMPLER, cfg.DATALOADER.NUM_INSTANCE = "softmax_triplet", 4
    cfg.DATALOADER.NATIVE_DECODE = value
    assert _start_logs(cfg, tmp_path / "out") == []
    stage2, stage1, val, *_ = make_dataloader(cfg)
    want = bool(value) and native_imageio_available()
    assert [b.native for b in (stage2.batcher, stage1.batcher, val)] == [want] * 3
