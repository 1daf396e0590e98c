"""DNA-Rendering .smc (HDF5) reader (a copy of the JAX package's
data/smc_reader.py; h5py and cv2 are imported where they are used).

Parity: data/dna_rendering/dna_rendering_sample_code/SMCReader.py (399 LoC).
The on-disk layout below is transcribed from that reader's accessors — it is
the dataset's documented schema, not a guess:

  root attrs: actor_id, performance_id, age, gender, height, weight, ethnicity
  Camera_5mp/ Camera_12mp/ Kinect/    group attrs: num_device, num_frame,
                                      resolution
  <group>/<camera_id>/<image_type>/<frame_id>  -> encoded image bytes
  Mask/<camera_id>/mask/<frame_id>             -> encoded mask bytes
  Camera_Parameter/<camera_id>/{D, K, RT, Color_Calibration}
  SMPLx/{betas, expression, fullpose, transl}  -> [num_frame, ...] arrays
  SMPLx/scale                                  -> scalar

Only the subset the pipeline uses (dataset_readers.py:1010-1180) is exposed:
actor info, color frames, masks, calibration, SMPL-X params. Unlike the
reference (which prints-and-returns-None on missing keys), missing groups
raise KeyError — fail loud.
"""
from __future__ import annotations

import numpy as np

# actor_info: reference SMCReader.__init__ maps root attrs to these keys
# (SMCReader.py:25-34). Missing attrs fall back rather than KeyError so
# partially-annotated files still load.
_ACTOR_ATTRS = (
    ("id", "actor_id"),
    ("perf_id", "performance_id"),
    ("age", "age"),
    ("gender", "gender"),
    ("height", "height"),
    ("weight", "weight"),
    ("ethnicity", "ethnicity"),
)


def _group_info(group) -> dict:
    """num_device/num_frame/resolution attrs (SMCReader.py:37-57)."""
    return {
        k: group.attrs[k]
        for k in ("num_device", "num_frame", "resolution")
        if k in group.attrs
    }


class SMCReader:
    def __init__(self, file_path: str):
        import h5py

        self._attach(h5py.File(file_path, "r"))

    def _attach(self, smc) -> None:
        """Read the root and group attributes of an open file (or any tree
        with h5py's group interface: `[]`, `in`, iteration, `.attrs`)."""
        self.smc = smc
        self.__calibration_dict__ = None
        self.__available_keys__ = list(self.smc.keys())

        attrs = dict(self.smc.attrs)
        self.actor_info = None
        if attrs:
            self.actor_info = {
                out_key: attrs[attr]
                for out_key, attr in _ACTOR_ATTRS
                if attr in attrs
            }
            g = self.actor_info.get("gender")
            if isinstance(g, bytes):
                self.actor_info["gender"] = g.decode()
        self.Camera_5mp_info = (
            _group_info(self.smc["Camera_5mp"])
            if "Camera_5mp" in self.smc else None
        )
        self.Camera_12mp_info = (
            _group_info(self.smc["Camera_12mp"])
            if "Camera_12mp" in self.smc else None
        )
        self.Kinect_info = (
            _group_info(self.smc["Kinect"]) if "Kinect" in self.smc else None
        )

    # ---------------- info ----------------
    def get_available_keys(self) -> list:
        return self.__available_keys__

    def get_actor_info(self):
        return self.actor_info

    def get_Camera_5mp_info(self):
        return self.Camera_5mp_info

    def get_Camera_12mp_info(self):
        return self.Camera_12mp_info

    def get_Kinect_info(self):
        return self.Kinect_info

    # ---------------- images ----------------
    def _decode(self, payload) -> np.ndarray:
        arr = np.asarray(payload)
        if arr.ndim == 1:  # jpeg/png bytes (SMCReader.__read_color_from_bytes__)
            import cv2

            return cv2.imdecode(arr, cv2.IMREAD_COLOR)
        return arr

    @staticmethod
    def _frame_list(group, Frame_id):
        """Normalize Frame_id (int/str/list/None) to a list of str keys.

        None = all frames in TIME order (int-sorted — a lexicographic sort
        would interleave '10' before '2')."""
        if Frame_id is None:
            return sorted(group, key=int)
        if isinstance(Frame_id, (list, tuple, range, np.ndarray)):
            return [str(int(f)) for f in Frame_id]
        return [str(int(Frame_id))]

    def get_img(self, Camera_group: str, Camera_id, Image_type: str = "color",
                Frame_id=None) -> np.ndarray:
        """color: HWC bgr uint8 (stacked [N,H,W,C] for list/None Frame_id)."""
        group = self.smc[Camera_group][str(Camera_id)][Image_type]
        frames = self._frame_list(group, Frame_id)
        imgs = [self._decode(group[f]) for f in frames]
        if isinstance(Frame_id, (int, str)):
            return imgs[0]
        return np.stack(imgs)

    def get_mask(self, Camera_id, Frame_id=None) -> np.ndarray:
        """mask: HW uint8 — decoded color collapsed by per-pixel channel max
        (SMCReader.py:214-216)."""
        group = self.smc["Mask"][str(Camera_id)]["mask"]
        frames = self._frame_list(group, Frame_id)
        masks = []
        for f in frames:
            m = self._decode(group[f])
            masks.append(np.max(m, 2) if m.ndim == 3 else m)
        if isinstance(Frame_id, (int, str)):
            return masks[0]
        return np.stack(masks)

    # ---------------- calibration ----------------
    def get_Calibration(self, Camera_id) -> dict:
        """{'D','K','RT','Color_Calibration'} for one camera
        (Camera_5mp ids '0'-'47', Camera_12mp '48'-'60')."""
        grp = self.smc["Camera_Parameter"][str(Camera_id)]
        out = {}
        for mt in ("D", "K", "RT", "Color_Calibration"):
            # Color_Calibration is absent from some exports; the pipeline
            # only consumes K/D/RT (dataset_readers.py:1049-1056).
            out[mt] = np.asarray(grp[mt]) if mt in grp else None
        return out

    def get_Calibration_all(self) -> dict:
        if self.__calibration_dict__ is None:
            self.__calibration_dict__ = {
                cid: self.get_Calibration(cid)
                for cid in self.smc["Camera_Parameter"]
            }
        return self.__calibration_dict__

    # ---------------- SMPL-X ----------------
    def get_SMPLx(self, Frame_id=None) -> dict:
        """SMPL-X mocap params (world coordinates).

        Matches SMCReader.py:350-389: every per-frame key is indexed
        `arr[frame_list, ...]`; `scale` rides along unindexed. betas /
        expression stored with a single row (some exports) broadcast to any
        frame rather than raising."""
        grp = self.smc["SMPLx"]
        if Frame_id is None:
            sel = slice(None)
        elif isinstance(Frame_id, (list, tuple, range, np.ndarray)):
            sel = [int(f) for f in Frame_id]
        else:
            sel = int(Frame_id)

        out = {}
        for key in ("betas", "expression", "fullpose", "transl"):
            arr = np.asarray(grp[key])
            if isinstance(sel, int) and arr.shape[0] <= sel:
                out[key] = arr[0]  # single-row betas/expression export
            else:
                out[key] = arr[sel, ...]
        if "scale" in grp:
            out["scale"] = np.asarray(grp["scale"])
        return out

    def get_frame_count(self, camera_group: str = "Camera_5mp",
                        camera_id=0) -> int:
        info = getattr(self, f"{camera_group}_info", None)
        if info and "num_frame" in info:
            return int(info["num_frame"])
        return len(self.smc[camera_group][str(camera_id)]["color"])

    def get_camera_ids(self, camera_group: str = "Camera_5mp") -> list:
        return sorted(self.smc[camera_group], key=lambda s: int(s))

    def release(self) -> None:
        self.smc.close()
        self.smc = None
        self.__calibration_dict__ = None
        self.__available_keys__ = None
        self.actor_info = None
        self.Camera_5mp_info = None
        self.Camera_12mp_info = None
        self.Kinect_info = None
