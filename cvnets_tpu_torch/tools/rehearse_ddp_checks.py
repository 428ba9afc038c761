"""Rehearse ``chip_smoke.py``'s phase-25 gloo check on the CPU at micro widths.

    python3 -m cvnets_tpu_torch.tools.rehearse_ddp_checks [LABEL ...]

Run from the repository root. Two gloo processes over a ``file://`` store
run ``chip_smoke.ddp_checks`` on the CPU for each path of
``chip_smoke.DDP_PATHS`` (all by default; LABEL is a key of it) with the
path's flags narrowed: MobileViTv2 at width 0.5 and 64², CLIP's towers at
ViT-tiny and one 64-wide text layer at 32², DeepLabv3 at width 0.5 with a
32-channel ASPP at 64², a few rows a rank. The check then runs as on the
card: the group's loss, gradients, BN statistics and the parameters' and
EMA's moves against one process on the whole batches and its noise floors,
and DeepLabv3's local-count test. On the CPU the wrappers run their kernels'
plain versions, so no launch is counted or expected. It prints the check's
lines and the record; any failed check raises.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

import chip_smoke

WIDTH = ["--model.classification.mitv2.width-multiplier", "0.5"]


def crop(side: int) -> list:
    return ["--sampler.bs.crop-size-width", str(side),
            "--sampler.bs.crop-size-height", str(side)]


# label → (flags, rows a rank, launches a step); no launch on the CPU
MICRO = {
    "MobileViTv2-1.0": (chip_smoke.FLAGSHIP_ARGS + WIDTH + crop(64), 4, {}),
    "CLIP ViT-B/16": (chip_smoke.CLIP_ARGS + [
        "--model.classification.vit.mode", "tiny",
        "--model.text.transformer.n-transformer-layers", "1",
        "--model.text.transformer.model-dim", "64",
        "--model.text.transformer.n-heads-per-layer", "2",
        "--model.multi-modal-image-text.clip.projection-dim", "32"] + crop(32), 3, {}),
    "DeepLabv3-MobileViTv2-1.0": (chip_smoke.DEEPLAB_ARGS + WIDTH + [
        "--model.segmentation.deeplabv3.aspp-out-channels", "32"] + crop(64), 2, {}),
}


def _rank(index: int, store: str, out_path: str, labels: list) -> None:
    from cvnets_tpu_torch.parallel import mesh

    torch.set_num_threads(2)
    chip_smoke.DDP_PATHS.clear()
    chip_smoke.DDP_PATHS.update({label: MICRO[label] for label in labels})
    mesh.init_group("gloo", index, 2, f"file://{store}", chip_smoke.DDP_TIMEOUT_S)
    chip_smoke.ddp_checks(labels, "CPU rehearsal", out_path, device=torch.device("cpu"))


def main(argv) -> int:
    from cvnets_tpu_torch import parallel

    labels = argv or list(MICRO)
    unknown = [label for label in labels if label not in MICRO]
    if unknown:
        print(f"rehearse_ddp_checks: unknown paths {unknown}; known: {list(MICRO)}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "gloo.json")
        parallel.spawn(_rank, 2, (os.path.join(tmp, "store"), out_path, labels),
                       timeout_s=chip_smoke.DDP_TIMEOUT_S)
        with open(out_path) as f:
            print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
