"""Channel rounding helpers: a copy of cvnets_tpu/utils/math_utils.py."""

from typing import Optional, Union


def make_divisible(v: Union[int, float], divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Round a channel count to a multiple of ``divisor`` without dropping more
    than 10% (the MobileNet rule)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return int(new_v)


def bound_fn(min_val: Union[int, float], max_val: Union[int, float],
             value: Union[int, float]) -> Union[int, float]:
    return max(min_val, min(max_val, value))
