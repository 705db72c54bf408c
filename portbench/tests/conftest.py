"""Shared settings of the benchmark's CPU tests: a cell shrunk to run in
seconds on the CPU (``MODEL.DEBUG_TINY``, 64 × 32 images, small sets), in
fp32 so that the port and the reference agree to round-off."""

import copy

import pytest
import torch

from portbench.harness import manifest

TINY = {"cfg": {"MODEL": {"DEBUG_TINY": True}, "INPUT": {"SIZE_TRAIN": [64, 32],
                                                         "SIZE_TEST": [64, 32]},
                "TPU": {"COMPUTE_DTYPE": "float32"}},
        "traffic": {"images": 256, "classes": 16, "batch": 16, "rows_per_unit": 2, "rows": 200,
                    "ids": 12, "query": 40, "gallery": 100}}

CELLS = ("vitb16-uniprompt.stage2a", "rn50-baseline.train", "vitb16-uniprompt.stage1a",
         "vitb16-uniprompt.eval")


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# The RN50 baseline cell's entries: its files are under portbench/, its
# entries are not in BENCHMARK.json (PERF.md, Open questions); the tests
# keep its program and reference running.
RN50 = "rn50-baseline.train"
RN50_ENTRIES = {
    "configs": {"name": "rn50-baseline", "source": "https://github.com/openai/CLIP",
                "file": "portbench/configs/rn50-baseline.json", "reduced": ["image_resolution"],
                "why": "CLIP RN50 ReID baseline"},
    "workloads": {"name": RN50, "config": "rn50-baseline", "traffic": "train", "chips": 1,
                  "why": "baseline epoch on a card-resident set"},
}


def cell(name: str) -> manifest.Cell:
    """The cell of that name, the RN50 one with its entries added."""
    bench = manifest.benchmark()
    if name == RN50:
        bench = copy.deepcopy(bench)
        for group, entry in RN50_ENTRIES.items():
            bench[group].append(entry)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m.get("moves", m["name"]) == "train_img_per_s" and "workloads" in m:
                m["workloads"].append(RN50)
    return manifest.Cell(name, bench)
