"""ResNet configuration: a copy of
cvnets_tpu/models/classification/config/resnet.py (depths 18, 34, 50 and 101,
and the SE widths of ``--model.classification.resnet.se-resnet``)."""

from typing import Dict

from cvnets_tpu_torch.utils import logger

_DEPTHS = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
}
_SE_CHANNELS = {
    "basic": [8, 8, 16, 32],
    "bottleneck": [16, 32, 64, 128],
}


def get_configuration(opts) -> Dict:
    depth = getattr(opts, "model.classification.resnet.depth", 50)
    se_resnet = getattr(opts, "model.classification.resnet.se_resnet", False)
    if depth not in _DEPTHS:
        logger.error(f"ResNet-{depth} unsupported; choose from {sorted(_DEPTHS)}")
    blocks, block_type = _DEPTHS[depth]
    mids = [64, 128, 256, 512]
    strides = [1, 2, 2, 2]
    cfg = {}
    for i, (n, mid, s) in enumerate(zip(blocks, mids, strides), start=2):
        cfg[f"layer{i}"] = {
            "num_blocks": n, "mid_channels": mid, "block_type": block_type,
            "stride": s,
        }
        if se_resnet:
            cfg[f"layer{i}"]["squeeze_channels"] = _SE_CHANNELS[block_type][i - 2]
    return cfg
