"""RegNet configuration: a copy of cvnets_tpu/models/classification/config/regnet.py,
operation for operation (the quantized linear widths of arXiv:2003.13678, eq.
2-3, in numpy as there; tests/test_torch_conv_families.py holds every mode's
stage widths, depths and groups to the JAX table)."""

from typing import Dict, List, Tuple

import numpy as np

from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.math_utils import make_divisible

# depth, w_0, w_a, w_m, group_width, se_ratio (0 for the X family)
_MODES = {
    "x_200mf": (13, 24, 36.44, 2.49, 8, 0.0),
    "x_400mf": (22, 24, 24.48, 2.54, 16, 0.0),
    "x_600mf": (16, 48, 36.97, 2.24, 24, 0.0),
    "x_800mf": (16, 56, 35.73, 2.28, 16, 0.0),
    "x_1.6gf": (18, 80, 34.01, 2.25, 24, 0.0),
    "x_3.2gf": (25, 88, 26.31, 2.25, 48, 0.0),
    "x_4.0gf": (23, 96, 38.65, 2.43, 40, 0.0),
    "x_6.4gf": (17, 184, 60.83, 2.07, 56, 0.0),
    "x_8.0gf": (23, 80, 49.56, 2.88, 120, 0.0),
    "x_12gf": (19, 168, 73.36, 2.37, 112, 0.0),
    "x_16gf": (22, 216, 55.59, 2.1, 128, 0.0),
    "x_32gf": (23, 320, 69.86, 2.0, 168, 0.0),
    "y_200mf": (13, 24, 36.44, 2.49, 8, 0.25),
    "y_400mf": (16, 48, 27.89, 2.09, 8, 0.25),
    "y_600mf": (15, 48, 32.54, 2.32, 16, 0.25),
    "y_800mf": (14, 56, 38.84, 2.4, 16, 0.25),
    "y_1.6gf": (27, 48, 20.71, 2.65, 24, 0.25),
    "y_3.2gf": (21, 80, 42.63, 2.66, 24, 0.25),
    "y_4.0gf": (22, 96, 31.41, 2.24, 64, 0.25),
    "y_6.4gf": (25, 112, 33.22, 2.27, 72, 0.25),
    "y_8.0gf": (17, 192, 76.82, 2.19, 56, 0.25),
    "y_12gf": (19, 168, 73.36, 2.37, 112, 0.25),
    "y_16gf": (18, 200, 106.23, 2.48, 112, 0.25),
    "y_32gf": (20, 232, 115.89, 2.53, 232, 0.25),
}


def _quantized_widths(depth: int, w_0: int, w_a: float, w_m: float,
                      quant: int = 8) -> List[int]:
    u = np.arange(depth) * w_a + w_0
    s = np.round(np.log(u / w_0) / np.log(w_m))
    return ((np.round(w_0 * np.power(w_m, s) / quant) * quant).astype(int).tolist())


def _per_stage(widths: List[int]) -> Tuple[List[int], List[int]]:
    stage_widths, stage_depths = [], []
    prev = None
    for w in widths:
        if w != prev:
            stage_widths.append(w)
            stage_depths.append(1)
            prev = w
        else:
            stage_depths[-1] += 1
    return stage_widths, stage_depths


def get_configuration(opts) -> Dict:
    mode = getattr(opts, "model.classification.regnet.mode", "y_400mf")
    if mode not in _MODES:
        logger.error(f"Unsupported RegNet mode {mode}; supported: {sorted(_MODES)}")
    depth, w_0, w_a, w_m, group_width, se_ratio = _MODES[mode]
    widths = _quantized_widths(depth, w_0, w_a, w_m)
    stage_widths, stage_depths = _per_stage(widths)

    # make widths/groups compatible (bottleneck multiplier = 1)
    gw = [min(group_width, w) for w in stage_widths]
    stage_widths = [make_divisible(w, g) for w, g in zip(stage_widths, gw)]

    cfg = {}
    for i, (w, d, g) in enumerate(zip(stage_widths, stage_depths, gw), start=1):
        cfg[f"layer{i}"] = {
            "depth": d, "width": w, "groups": g, "stride": 2,
            "bottleneck_multiplier": 1.0, "se_ratio": se_ratio,
        }
    return cfg
