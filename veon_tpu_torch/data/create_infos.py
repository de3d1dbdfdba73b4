"""nuScenes info generation without the devkit (counterpart of
`veon_tpu/data/create_infos.py`): the raw JSON tables read directly into
the bevdetv2 info layout the datasets consume (camera calibration, ego
poses and the occ GT path per key-frame sample). GT boxes are not emitted:
the occupancy path never reads them.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

CAM_CHANNELS = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
)


def _load_table(root: str, version: str, name: str) -> List[Dict[str, Any]]:
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def create_infos(
    root: str,
    version: str = "v1.0-trainval",
    val_scene_names: Optional[Sequence[str]] = None,
    out_prefix: Optional[str] = None,
) -> Dict[str, List[Dict[str, Any]]]:
    """Build train/val info lists from the raw nuScenes tables.

    Args:
      root: dataset root containing <version>/ with the JSON tables and the
        samples/ image tree; occ GT is expected under root/gts/<scene>/<token>
        (the Occ3D-nuScenes layout, `add_ann_adj_info` in
        create_data_bevdet.py:102+).
      val_scene_names: scene names routed to the val split.
      out_prefix: when set, pickles are written to
        f"{out_prefix}_infos_{split}.pkl".

    Returns {"train": [...], "val": [...]}, each info carrying token,
    timestamp, scene_token, lidar_path, occ_path, lidar2ego_*, ego2global_*
    and per-camera cams{} exactly as NuScenesOccDataset consumes them.
    """
    val_scene_names = set(val_scene_names or ())
    sensors = {s["token"]: s for s in _load_table(root, version, "sensor")}
    calibs = {c["token"]: c for c in _load_table(root, version, "calibrated_sensor")}
    ego_poses = {e["token"]: e for e in _load_table(root, version, "ego_pose")}
    scenes = {s["token"]: s for s in _load_table(root, version, "scene")}
    samples = _load_table(root, version, "sample")
    sample_data = _load_table(root, version, "sample_data")

    # key-frame sample_data grouped by (sample_token, channel)
    by_sample: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for sd in sample_data:
        if not sd.get("is_key_frame", False):
            continue
        channel = sensors[calibs[sd["calibrated_sensor_token"]]["sensor_token"]]["channel"]
        by_sample.setdefault(sd["sample_token"], {})[channel] = sd

    out: Dict[str, List[Dict[str, Any]]] = {"train": [], "val": []}
    for sample in sorted(samples, key=lambda s: s["timestamp"]):
        sds = by_sample.get(sample["token"], {})
        if "LIDAR_TOP" not in sds:
            continue
        lidar_sd = sds["LIDAR_TOP"]
        lidar_calib = calibs[lidar_sd["calibrated_sensor_token"]]
        lidar_pose = ego_poses[lidar_sd["ego_pose_token"]]
        scene = scenes[sample["scene_token"]]

        cams: Dict[str, Dict[str, Any]] = {}
        for cam in CAM_CHANNELS:
            if cam not in sds:
                continue
            sd = sds[cam]
            calib = calibs[sd["calibrated_sensor_token"]]
            pose = ego_poses[sd["ego_pose_token"]]
            cams[cam] = {
                "data_path": os.path.join(root, sd["filename"]),
                "cam_intrinsic": calib["camera_intrinsic"],
                "sensor2ego_rotation": calib["rotation"],
                "sensor2ego_translation": calib["translation"],
                "ego2global_rotation": pose["rotation"],
                "ego2global_translation": pose["translation"],
            }
        if len(cams) != len(CAM_CHANNELS):
            continue

        info = {
            "token": sample["token"],
            "timestamp": sample["timestamp"],
            "scene_token": sample["scene_token"],
            "lidar_path": os.path.join(root, lidar_sd["filename"]),
            "occ_path": os.path.join(root, "gts", scene["name"], sample["token"]),
            "lidar2ego_rotation": lidar_calib["rotation"],
            "lidar2ego_translation": lidar_calib["translation"],
            "ego2global_rotation": lidar_pose["rotation"],
            "ego2global_translation": lidar_pose["translation"],
            "cams": cams,
        }
        split = "val" if scene["name"] in val_scene_names else "train"
        out[split].append(info)

    if out_prefix:
        for split, infos in out.items():
            path = f"{out_prefix}_infos_{split}.pkl"
            with open(path, "wb") as f:
                pickle.dump({"infos": infos, "metadata": {"version": version}}, f)
    return out
