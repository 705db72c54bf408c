"""Dataset record schema and statistics.

The reference represents every sample as an ``(img_path, pid, camid, trackid)``
tuple (reference ``datasets/bases.py:31-44``); loaders expose ``train`` /
``query`` / ``gallery`` lists plus per-split statistics. Same contract here,
minus torch.

A copy kept in the port (ref mpreid_tpu/data/base.py::ReIDDataset), so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple


class Record(NamedTuple):
    img_path: str
    pid: int
    camid: int
    trackid: int


def imagedata_info(data: List[Record]):
    pids = {r[1] for r in data}
    cams = {r[2] for r in data}
    tracks = {r[3] for r in data}
    return len(pids), len(data), len(cams), len(tracks)


@dataclass
class ReIDDataset:
    """Container with the reference's attribute surface (num_train_pids etc.)."""

    train: List[Record] = field(default_factory=list)
    query: List[Record] = field(default_factory=list)
    gallery: List[Record] = field(default_factory=list)

    def __post_init__(self):
        (self.num_train_pids, self.num_train_imgs,
         self.num_train_cams, self.num_train_vids) = imagedata_info(self.train)
        (self.num_query_pids, self.num_query_imgs,
         self.num_query_cams, self.num_query_vids) = imagedata_info(self.query)
        (self.num_gallery_pids, self.num_gallery_imgs,
         self.num_gallery_cams, self.num_gallery_vids) = imagedata_info(self.gallery)

    def statistics(self) -> str:
        rows = [
            ("train", self.num_train_pids, self.num_train_imgs, self.num_train_cams),
            ("query", self.num_query_pids, self.num_query_imgs, self.num_query_cams),
            ("gallery", self.num_gallery_pids, self.num_gallery_imgs, self.num_gallery_cams),
        ]
        lines = [
            "Dataset statistics:",
            "  ----------------------------------------",
            "  subset   | # ids | # images | # cameras",
            "  ----------------------------------------",
        ]
        for name, pids, imgs, cams in rows:
            lines.append(f"  {name:<8} | {pids:5d} | {imgs:8d} | {cams:9d}")
        lines.append("  ----------------------------------------")
        return "\n".join(lines)
