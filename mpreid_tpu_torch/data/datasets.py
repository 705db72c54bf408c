"""Dataset loaders — path/regex/split logic for every supported benchmark.

One loader per benchmark family, matching the reference's directory layouts
and id/camera parsing exactly (citations inline). All loaders return a
``ReIDDataset`` of ``(img_path, pid, camid, trackid)`` records.

Reference defects deliberately *fixed* here (SURVEY.md §7 "defects"):
  * MMMP ignores ``root`` and hardcodes ``/data/mmmp1_10``
    (ref ``mmmp.py:11,18-20``) — here ``root`` is honored.
  * MMMP parses camid as the single char at ``img_path[-15]``
    (ref ``mmmp.py:128``), aliasing cameras 10–14 onto 0–4 — here the camid
    comes from the camera directory name (2 digits). The legacy behavior is
    available via ``legacy_camid=True``.
  * MMMP emits trackid 0 always (ref ``mmmp.py:132``), starving the
    stage-1b view→(platform, modality) mapping — here ``trackid`` carries the
    camera id (0-based) so it can serve as the view label.
No downloads are performed (the reference auto-downloads DukeMTMC,
ref ``dukemtmcreid.py:62-77`` — pointless in an egress-free deployment).

A copy kept in the port (ref mpreid_tpu/data/datasets.py::build_dataset), so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
import random
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from .base import ReIDDataset, Record


def _require(path: str) -> None:
    if not osp.exists(path):
        raise RuntimeError(f"'{path}' is not available")


def _relabel_map(pids: Sequence[int]) -> Dict[int, int]:
    # The reference builds pid2label from a *set* (e.g. market1501.py:70-73),
    # whose iteration order for small ints is ascending in practice; we sort
    # explicitly for guaranteed determinism.
    return {pid: label for label, pid in enumerate(sorted(set(pids)))}


# ---------------------------------------------------------------------------
# market-1501-style: dir glob + ([-\d]+)_c(\d) filename pattern
# ---------------------------------------------------------------------------

def _market_style_dir(
    dir_path: str,
    relabel: bool,
    pid_begin: int = 0,
    cam_digits: int = 1,
    pid_max: Optional[int] = None,
    cam_range: Optional[tuple] = None,
    trackid: int = 0,
) -> List[Record]:
    """Parse a flat dir of ``{pid}_c{cam}...jpg`` files (ref market1501.py:64-84)."""
    pattern = re.compile(r"([-\d]+)_c(\d+)" if cam_digits > 1 else r"([-\d]+)_c(\d)")
    img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
    pids = []
    for p in img_paths:
        pid = int(pattern.search(p).group(1))
        if pid == -1:
            continue
        pids.append(pid)
    pid2label = _relabel_map(pids)
    out: List[Record] = []
    for p in img_paths:
        pid, camid = map(int, pattern.search(p).groups())
        if pid == -1:
            continue
        if pid_max is not None:
            assert 0 <= pid <= pid_max
        if cam_range is not None:
            assert cam_range[0] <= camid <= cam_range[1]
        camid -= 1
        if relabel:
            pid = pid2label[pid]
        out.append(Record(p, pid_begin + pid, camid, trackid))
    return out


class Market1501(ReIDDataset):
    """Market-1501 (ref datasets/market1501.py)."""

    dataset_dir = "Market-1501-v15.09.15"

    def __init__(self, root: str = "", pid_begin: int = 0, **kwargs):
        base = osp.join(root, self.dataset_dir)
        dirs = {
            "train": osp.join(base, "bounding_box_train"),
            "query": osp.join(base, "query"),
            "gallery": osp.join(base, "bounding_box_test"),
        }
        for d in [base, *dirs.values()]:
            _require(d)
        super().__init__(
            train=_market_style_dir(dirs["train"], True, pid_begin, pid_max=1501, cam_range=(1, 6)),
            query=_market_style_dir(dirs["query"], False, pid_begin, pid_max=1501, cam_range=(1, 6)),
            gallery=_market_style_dir(dirs["gallery"], False, pid_begin, pid_max=1501, cam_range=(1, 6)),
        )


class DukeMTMCreID(ReIDDataset):
    """DukeMTMC-reID (ref datasets/dukemtmcreid.py); no auto-download."""

    dataset_dir = "dukemtmcreid"

    def __init__(self, root: str = "", pid_begin: int = 0, **kwargs):
        base = osp.join(root, self.dataset_dir, "DukeMTMC-reID")
        dirs = [osp.join(base, d) for d in ("bounding_box_train", "query", "bounding_box_test")]
        for d in dirs:
            _require(d)
        super().__init__(
            train=_market_style_dir(dirs[0], True, pid_begin, cam_range=(1, 8)),
            query=_market_style_dir(dirs[1], False, pid_begin, cam_range=(1, 8)),
            gallery=_market_style_dir(dirs[2], False, pid_begin, cam_range=(1, 8)),
        )


class OccDukeMTMCreID(ReIDDataset):
    """Occluded-Duke (ref datasets/occ_duke.py — trackid is 1 there)."""

    dataset_dir = "dukemtmcreid"

    def __init__(self, root: str = "", pid_begin: int = 0, **kwargs):
        base = osp.join(root, self.dataset_dir, "Occluded_Duke")
        dirs = [osp.join(base, d) for d in ("bounding_box_train", "query", "bounding_box_test")]
        for d in dirs:
            _require(d)
        super().__init__(
            train=_market_style_dir(dirs[0], True, pid_begin, cam_range=(1, 8), trackid=1),
            query=_market_style_dir(dirs[1], False, pid_begin, cam_range=(1, 8), trackid=1),
            gallery=_market_style_dir(dirs[2], False, pid_begin, cam_range=(1, 8), trackid=1),
        )


class G2APS(ReIDDataset):
    """G2APS in market1501 layout (ref datasets/g2aps.py)."""

    dataset_dir = "G2APS_in_market1501_style/Market-1501-v15.09.15"

    def __init__(self, root: str = "", pid_begin: int = 0, **kwargs):
        base = osp.join(root, self.dataset_dir)
        dirs = [osp.join(base, d) for d in ("bounding_box_train", "query", "bounding_box_test")]
        for d in dirs:
            _require(d)
        super().__init__(
            train=_market_style_dir(dirs[0], True, pid_begin),
            query=_market_style_dir(dirs[1], False, pid_begin),
            gallery=_market_style_dir(dirs[2], False, pid_begin),
        )


# ---------------------------------------------------------------------------
# MSMT17: list-file driven (ref datasets/msmt17.py)
# ---------------------------------------------------------------------------

class MSMT17(ReIDDataset):
    dataset_dir = "MSMT17"

    def __init__(self, root: str = "", pid_begin: int = 0, **kwargs):
        base = osp.join(root, self.dataset_dir)
        train_dir = osp.join(base, "train")
        test_dir = osp.join(base, "test")
        for d in (base, train_dir, test_dir):
            _require(d)

        def from_list(dir_path, list_name):
            out = []
            with open(osp.join(base, list_name)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    img_rel, pid = line.split(" ")
                    camid = int(img_rel.split("_")[2])
                    out.append(
                        Record(osp.join(dir_path, img_rel), pid_begin + int(pid), camid - 1, 0)
                    )
            return out

        train = from_list(train_dir, "list_train.txt") + from_list(train_dir, "list_val.txt")
        super().__init__(
            train=train,
            query=from_list(test_dir, "list_query.txt"),
            gallery=from_list(test_dir, "list_gallery.txt"),
        )


# ---------------------------------------------------------------------------
# MMMP: multi-modal multi-platform (ref datasets/mmmp.py)
# ---------------------------------------------------------------------------

# camera groups (ref mmmp.py:81-109): 01-06 CCTV-RGB, 07-12 CCTV-IR,
# 13 UAV-RGB, 14 UAV-thermal
_MMMP_GROUPS = {
    ("cctv", "rgb"): ["01", "02", "03", "04", "05", "06"],
    ("cctv", "ir"): ["07", "08", "09", "10", "11", "12"],
    ("uav", "rgb"): ["13"],
    ("uav", "ir"): ["14"],
}
_MMMP_SINGLE = {
    "cctv": [f"{i:02d}" for i in range(1, 13)],
    "uav": ["13", "14"],
    "ir": ["07", "08", "09", "10", "11", "12", "14"],
    "rgb": ["01", "02", "03", "04", "05", "06", "13"],
}


def _mmmp_cameras(tokens: Sequence[str]) -> List[str]:
    if len(tokens) == 2:
        return list(_MMMP_SINGLE[tokens[1]])
    return list(_MMMP_GROUPS[(tokens[1], tokens[2])]) + list(
        _MMMP_GROUPS[(tokens[3], tokens[4])]
    )


class MMMP(ReIDDataset):
    """MP-ReID dataset with exp_setting-driven splits.

    ``exp_setting`` forms (ref mmmp.py:22-28):
      * ``exp_<group>`` (2 tokens, e.g. ``exp_rgb``) — same-modality eval:
        query/gallery from a random per-(pid, cam) 50/50 split of the test
        ids (``_process_same``, ref mmmp.py:217-286),
      * ``exp_<plat>_<mod>_<plat>_<mod>`` (5 tokens, e.g.
        ``exp_cctv_ir_cctv_rgb``) — cross-domain eval: query cameras from
        tokens[1:3], gallery cameras from tokens[3:5].
    Train ids = train_id.txt + val_id.txt over the union of both camera
    groups (ref mmmp.py:66-131).
    """

    def __init__(
        self,
        root: str = "",
        pid_begin: int = 0,
        exp_setting: Optional[str] = None,
        legacy_camid: bool = False,
        split_seed: Optional[int] = None,
        **kwargs,
    ):
        if exp_setting is None:
            raise ValueError("MMMP requires exp_setting (e.g. 'exp_cctv_ir_cctv_rgb')")
        base = root or "/data/mmmp1_10"
        tokens = exp_setting.split("_")
        self.legacy_camid = legacy_camid
        self._rng = random.Random(split_seed)

        def read_ids(name):
            with open(osp.join(base, exp_setting, name)) as f:
                first = f.read().splitlines()[0]
            return [f"{int(x):04d}" for x in first.split(",")]

        train_ids = read_ids("train_id.txt") + read_ids("val_id.txt")
        test_ids = read_ids("test_id.txt")

        train = self._collect(base, train_ids, _mmmp_cameras(tokens), relabel=True,
                              pid_begin=pid_begin)
        if len(tokens) == 2:
            query, gallery = self._split_same(
                base, test_ids, _MMMP_SINGLE[tokens[1]], pid_begin
            )
        elif len(tokens) == 5:
            query = self._collect(
                base, test_ids, _MMMP_GROUPS[(tokens[1], tokens[2])], relabel=False,
                pid_begin=pid_begin,
            )
            gallery = self._collect(
                base, test_ids, _MMMP_GROUPS[(tokens[3], tokens[4])], relabel=False,
                pid_begin=pid_begin,
            )
        else:
            raise ValueError(f"Bad MMMP exp_setting: {exp_setting}")
        super().__init__(train=train, query=query, gallery=gallery)

    def _files_for(self, base: str, ids: Sequence[str], cameras: Sequence[str]):
        for pid_str in sorted(ids):
            for cam in cameras:
                img_dir = osp.join(base, cam, pid_str)
                if osp.isdir(img_dir):
                    for name in sorted(os.listdir(img_dir)):
                        yield osp.join(img_dir, name), int(pid_str), int(cam) - 1

    def _parse_cam(self, img_path: str, cam_from_dir: int) -> int:
        if self.legacy_camid:
            return int(img_path[-15])  # ref mmmp.py:128 (aliases cams 10-14)
        return cam_from_dir

    def _collect(self, base, ids, cameras, relabel, pid_begin) -> List[Record]:
        entries = list(self._files_for(base, ids, cameras))
        pid2label = _relabel_map([pid for _, pid, _ in entries])
        out = []
        for path, pid, cam in entries:
            camid = self._parse_cam(path, cam)
            label = pid2label[pid] if relabel else pid
            # trackid doubles as the view label for stage-1b prompt training
            out.append(Record(path, pid_begin + label, camid, camid))
        return out

    def _split_same(self, base, ids, cameras, pid_begin, split_ratio=0.5):
        """Random per-(pid, cam) 50/50 query/gallery split (ref mmmp.py:217-286)."""
        groups: Dict[tuple, List[str]] = defaultdict(list)
        for path, pid, cam in self._files_for(base, ids, cameras):
            camid = self._parse_cam(path, cam)
            groups[(pid, camid)].append(path)
        query, gallery = [], []
        for (pid, camid), files in groups.items():
            if len(files) == 1:
                continue  # singletons dropped (ref mmmp.py:252-253)
            shuffled = files.copy()
            self._rng.shuffle(shuffled)
            split = max(1, int(len(files) * split_ratio))
            for p in shuffled[:split]:
                query.append(Record(p, pid_begin + pid, camid, camid))
            for p in shuffled[split:]:
                gallery.append(Record(p, pid_begin + pid, camid, camid))
        return query, gallery


# ---------------------------------------------------------------------------
# SYSU-MM01 (ref datasets/sysu.py)
# ---------------------------------------------------------------------------

class SYSU(ReIDDataset):
    """SYSU-MM01 cross-modality. RGB cams 1,2,4,5; IR cams 3,6."""

    rgb_cameras = ["cam1", "cam2", "cam4", "cam5"]
    ir_cameras = ["cam3", "cam6"]

    def __init__(self, root: str = "", pid_begin: int = 0,
                 exp_setting: Optional[str] = None, **kwargs):
        base = root or "/nas_24/sysu"
        self.base = base
        self.pid_begin = pid_begin
        all_cams = self.rgb_cameras + self.ir_cameras
        self.cam_ids = {name: i + 1 for i, name in enumerate(all_cams)}

        def read_ids(name):
            with open(osp.join(base, "exp", name)) as f:
                content = f.read().strip()
            raw = content.split(",") if "," in content else content.splitlines()
            return [f"{int(x):04d}" for x in raw if x.strip()]

        train_ids = sorted(set(read_ids("train_id.txt") + read_ids("val_id.txt")))
        test_ids = read_ids("test_id.txt")

        train = self._collect(train_ids, all_cams, relabel=True)
        if exp_setting == "all_train_rgb2ir":
            query = self._collect(test_ids, self.rgb_cameras, relabel=False)
            gallery = self._collect(test_ids, self.ir_cameras, relabel=False)
        elif exp_setting == "all_train_ir2rgb":
            query = self._collect(test_ids, self.ir_cameras, relabel=False)
            gallery = self._collect(test_ids, self.rgb_cameras, relabel=False)
        else:
            raise ValueError(f"Unsupported SYSU exp_setting: {exp_setting}")
        super().__init__(train=train, query=query, gallery=gallery)

    def _collect(self, ids, cameras, relabel) -> List[Record]:
        pid2label = _relabel_map([int(s) for s in ids]) if relabel else None
        out = []
        for pid_str in sorted(ids):
            pid = int(pid_str)
            for cam in cameras:
                img_dir = osp.join(self.base, cam, pid_str)
                if not osp.isdir(img_dir):
                    continue
                for name in sorted(os.listdir(img_dir)):
                    if not name.lower().endswith((".jpg", ".jpeg", ".png")):
                        continue
                    label = pid2label[pid] if relabel else pid
                    out.append(
                        Record(osp.join(img_dir, name), self.pid_begin + label,
                               self.cam_ids[cam], 0)
                    )
        return out


# ---------------------------------------------------------------------------
# RegDB (ref datasets/regdb.py)
# ---------------------------------------------------------------------------

class RegDB(ReIDDataset):
    """RegDB visible↔thermal. exp_setting '{rgb2ir|ir2rgb}_{trial}'.

    camid 0 = visible, 1 = thermal (ref regdb.py:63-64). Train ids come
    pre-relabeled by the idx files.
    """

    def __init__(self, root: str = "", pid_begin: int = 0,
                 exp_setting: str = "rgb2ir_1", **kwargs):
        base = root or "/nas_24/RegDB"
        self.base = base
        self.pid_begin = pid_begin
        direction, trial = exp_setting.split("_")

        vis_train = self._read_idx(osp.join(base, "idx", f"train_visible_{trial}.txt"))
        th_train = self._read_idx(osp.join(base, "idx", f"train_thermal_{trial}.txt"))
        vis_test = self._read_idx(osp.join(base, "idx", f"test_visible_{trial}.txt"))
        th_test = self._read_idx(osp.join(base, "idx", f"test_thermal_{trial}.txt"))

        train = self._build(vis_train, 0, relabel=True) + self._build(th_train, 1, relabel=True)
        if direction == "rgb2ir":
            query = self._build(vis_test, 0, relabel=False)
            gallery = self._build(th_test, 1, relabel=False)
        elif direction == "ir2rgb":
            query = self._build(th_test, 1, relabel=False)
            gallery = self._build(vis_test, 0, relabel=False)
        else:
            raise ValueError(f"Unsupported RegDB exp_setting: {exp_setting}")
        super().__init__(train=train, query=query, gallery=gallery)

    @staticmethod
    def _read_idx(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                img_rel, relabel_id = line.split()
                try:
                    orig = int(img_rel.split("/")[1])
                except (IndexError, ValueError):
                    orig = int(img_rel.split("_")[-1].split(".")[0])
                out.append((img_rel, orig, int(relabel_id)))
        return out

    def _build(self, data, cam_id, relabel) -> List[Record]:
        return [
            Record(osp.join(self.base, rel), self.pid_begin + (new if relabel else orig),
                   cam_id, 0)
            for rel, orig, new in data
        ]


# ---------------------------------------------------------------------------
# Vehicle datasets (ref datasets/veri.py, vehicleid.py)
# ---------------------------------------------------------------------------

class VeRi(ReIDDataset):
    """VeRi-776 with viewpoint labels from keypoint txt files."""

    dataset_dir = "VeRi"

    def __init__(self, root: str = "", keypoint_dir: Optional[str] = None, **kwargs):
        base = osp.join(root, self.dataset_dir)
        dirs = {
            "train": osp.join(base, "image_train"),
            "query": osp.join(base, "image_query"),
            "gallery": osp.join(base, "image_test"),
        }
        for d in [base, *dirs.values()]:
            _require(d)
        kp = keypoint_dir or osp.join(base, "keypoints")
        self.view_map: Dict[str, int] = {}
        for name in ("keypoint_train.txt", "keypoint_test.txt"):
            path = osp.join(kp, name)
            if osp.exists(path):
                with open(path) as f:
                    for line in f:
                        parts = line.split(" ")
                        self.view_map[osp.basename(parts[0])] = int(parts[-1])
        super().__init__(
            train=self._dir(dirs["train"], relabel=True),
            query=self._dir(dirs["query"], relabel=False),
            gallery=self._dir(dirs["gallery"], relabel=False),
        )

    def _dir(self, dir_path, relabel) -> List[Record]:
        pattern = re.compile(r"([-\d]+)_c(\d+)")
        img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
        pids = [int(pattern.search(p).group(1)) for p in img_paths]
        pid2label = _relabel_map([p for p in pids if p != -1])
        out = []
        for p in img_paths:
            pid, camid = map(int, pattern.search(p).groups())
            if pid == -1:
                continue
            assert 0 <= pid <= 776 and 1 <= camid <= 20
            name = osp.basename(p)
            if name not in self.view_map:
                continue  # ref veri.py:102-109: skip unannotated samples
            out.append(
                Record(p, pid2label[pid] if relabel else pid, camid - 1, self.view_map[name])
            )
        return out


class VehicleID(ReIDDataset):
    """VehicleID with per-trial random gallery sampling (ref vehicleid.py).

    Per test identity one random image goes to the gallery, the rest are
    queries; query camid 0, gallery camid 1 to keep eval well-formed. Call
    ``resample()`` to draw a new trial (10-trial averaging, ref test.py:46-63).
    """

    dataset_dir = "VehicleID_V1.0"

    def __init__(self, root: str = "", test_size: int = 800, seed: Optional[int] = None,
                 **kwargs):
        base = osp.join(root, self.dataset_dir)
        self.img_dir = osp.join(base, "image")
        split_dir = osp.join(base, "train_test_split")
        _require(base)
        _require(split_dir)
        if test_size not in (800, 1600, 2400):
            raise RuntimeError(f'"{test_size}" is not available')
        self._rng = random.Random(seed)

        self.train_pid_dict = self._read_list(osp.join(split_dir, "train_list.txt"))
        self.test_pid_dict = self._read_list(osp.join(split_dir, f"test_list_{test_size}.txt"))
        if len(self.train_pid_dict) != 13164:
            raise AssertionError(
                f"There should be 13164 vehicles for training, got {len(self.train_pid_dict)}"
            )
        if len(self.test_pid_dict) != test_size:
            raise AssertionError(
                f"There should be {test_size} vehicles for testing, got {len(self.test_pid_dict)}"
            )

        train_pids = sorted(self.train_pid_dict)
        pid2label = _relabel_map(train_pids)
        train = [
            Record(osp.join(self.img_dir, name + ".jpg"), pid2label[pid], 0, 1)
            for pid in train_pids
            for name in self.train_pid_dict[pid]
        ]
        query, gallery = self._draw_trial()
        super().__init__(train=train, query=query, gallery=gallery)

    @staticmethod
    def _read_list(path):
        d: Dict[int, List[str]] = defaultdict(list)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name, pid = line.split(" ")
                d[int(pid)].append(name)
        return d

    def _draw_trial(self):
        query, gallery = [], []
        for pid, names in self.test_pid_dict.items():
            chosen = self._rng.choice(names)
            for name in names:
                rec = Record(osp.join(self.img_dir, name + ".jpg"), pid, 0, 1)
                if name == chosen:
                    gallery.append(rec._replace(camid=1))
                else:
                    query.append(rec)
        return query, gallery

    def resample(self):
        """Draw a fresh random gallery split (one VehicleID eval trial)."""
        self.query, self.gallery = self._draw_trial()
        self.__post_init__()


# ---------------------------------------------------------------------------
# AG-ReID v2 (ref datasets/agreidv2.py) — attributes optional
# ---------------------------------------------------------------------------

class AGReIDv2(ReIDDataset):
    """Aerial-ground ReID v2: split-file driven query/gallery lists.

    Filename pattern ``P*T*A*`` (identity) + ``C*F*`` (camera/frame). The
    reference also loads a .mat attribute table via mat4py
    (ref agreidv2.py:100-120) — exposed via ``load_attributes()`` when a
    reader is available; attributes are unused by any training path.
    """

    _pid_re = re.compile(r"P([-\d]+)T([-\d]+)A([-\d]+)")
    _cam_re = re.compile(r"C([-\d]+)F([-\d]+)")

    def __init__(self, root: str = "", exp_setting: Optional[str] = None, **kwargs):
        self.base = root
        _require(osp.join(root, "train_all"))
        split_file = osp.join(root, f"{exp_setting}.txt") if exp_setting else None
        if not (split_file and osp.exists(split_file)):
            raise RuntimeError(f"AGReIDv2 requires an exp_setting split file, got {split_file}")
        query_list, gallery_list = [], []
        with open(split_file) as f:
            for line in f:
                line = line.strip()
                if line.startswith("query/"):
                    query_list.append(osp.join(root, line))
                elif line.startswith("gallery/"):
                    gallery_list.append(osp.join(root, line))
        train_paths = sorted(
            glob.glob(osp.join(root, "train_all", "**", "*.jpg"), recursive=True)
        )
        super().__init__(
            train=self._from_list(train_paths),
            query=self._from_list(query_list),
            gallery=self._from_list(gallery_list),
        )
        self.num_train_vids = self.num_query_vids = self.num_gallery_vids = 1

    def _from_list(self, paths) -> List[Record]:
        pids = []
        for p in paths:
            g = self._pid_re.search(osp.basename(p)).groups()
            pids.append(int("".join(g)))
        pid2label = _relabel_map(pids)
        out = []
        for p in paths:
            name = osp.basename(p)
            g = self._pid_re.search(name).groups()
            pid = pid2label[int("".join(g))]
            camid = int(self._cam_re.search(name).group(1))
            out.append(Record(p, pid, camid, 0))
        return out

    def load_attributes(self, mat_path: Optional[str] = None):
        """Attribute dict (id → ±1 vector); requires the optional mat4py dep."""
        try:
            import mat4py  # noqa
        except ImportError as e:
            raise ImportError("AG-ReID attributes need mat4py, not installed") from e
        import numpy as np

        path = mat_path or osp.join(self.base, "qut_attribute_v8.mat")
        data = mat4py.loadmat(path)["qut_attribute"]
        out = {}
        for split in ("train", "test"):
            tbl = data[split]
            idx = tbl["image_index"]
            keys = [k for k in tbl if k != "image_index"]
            for i, image_index in enumerate(idx):
                vec = np.array([int(tbl[k][i]) for k in keys]) * 2 - 3
                out[str(int(image_index))] = vec
        return out


# ---------------------------------------------------------------------------
# registry (ref make_dataloader_uniprompt.py:22-34)
# ---------------------------------------------------------------------------

DATASET_REGISTRY = {
    "market1501": Market1501,
    "dukemtmc": DukeMTMCreID,
    "msmt17": MSMT17,
    "occ_duke": OccDukeMTMCreID,
    "veri": VeRi,
    "VehicleID": VehicleID,
    "mmmp": MMMP,
    "sysu": SYSU,
    "regdb": RegDB,
    "agreidv2": AGReIDv2,
    "g2aps": G2APS,
}


def build_dataset(name: str, root: str, **kwargs) -> ReIDDataset:
    if name not in DATASET_REGISTRY:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[name](root=root, **kwargs)
