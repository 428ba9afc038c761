"""The constant-pixel-budget (h, w, batch size) schedule of the variable-batch
sampler (counterpart of cvnets_tpu/data/sampler/utils.py):
bsz ≈ crop_h·crop_w·base_bsz / (h·w)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def create_intervallic_integer_list(base_val: int, min_val: int, max_val: int,
                                    num_scales: int = 5, check_div_factor: int = 32
                                    ) -> List[int]:
    values = set(np.linspace(min_val, max_val, num_scales).astype(int).tolist())
    values.add(base_val)
    # each snapped to the nearest multiple of check_div_factor
    return sorted({max(check_div_factor, int(round(v / check_div_factor) * check_div_factor))
                   for v in values})


def image_batch_pairs(crop_size_w: int, crop_size_h: int, batch_size_gpu0: int,
                      max_scales: int = 5, check_scale_div_factor: int = 32,
                      min_crop_size_w: int = 160, max_crop_size_w: int = 320,
                      min_crop_size_h: int = 160, max_crop_size_h: int = 320
                      ) -> List[Tuple[int, int, int]]:
    width_dims = create_intervallic_integer_list(
        crop_size_w, min_crop_size_w, max_crop_size_w, max_scales, check_scale_div_factor)
    height_dims = create_intervallic_integer_list(
        crop_size_h, min_crop_size_h, max_crop_size_h, max_scales, check_scale_div_factor)
    n_elements = crop_size_w * crop_size_h * batch_size_gpu0
    return sorted({(crop_h, crop_w, max(1, int(round(n_elements / (crop_h * crop_w), 2))))
                   for crop_h, crop_w in zip(height_dims, width_dims)})
