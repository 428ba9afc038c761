"""Rehearse ``chip_smoke.py``'s phase-26 checks on the CPU at micro widths.

    python3 -m cvnets_tpu_torch.tools.rehearse_model_parallel_checks [LABEL ...]

Run from the repository root. (a) ``chip_smoke.ring_check`` on the CPU at
(B 2, S 64, 4 heads of 16): the ring's blocks against the whole sequence,
through the plain twins. (b) Two gloo processes over a ``file://`` store run
``chip_smoke.ddp_checks`` for each path of ``chip_smoke.MP_PATHS`` (all by
default; LABEL is a key of it), its grid flags as they are and its model
narrowed to the micro ViT (64 wide, 2 blocks of 4 heads) at 64² (16 tokens
under the ring), a few rows a data rank: the group's loss, gradients, BN
statistics and moves against one process and its noise floors, with the
state bytes, launches and MoE drops printed as on the card. On the CPU the
wrappers run their kernels' plain versions, so no launch is counted or
expected. Any failed check raises.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

import chip_smoke

MICRO_VIT = ["--model.classification.vit.mode", "micro",
             "--sampler.bs.crop-size-width", "64", "--sampler.bs.crop-size-height", "64"]
# label → (flags, rows a data rank, launches a step, grid flags); no launch on the CPU
MICRO = {label: (flags + MICRO_VIT, 2, {}, grid)
         for label, (flags, _, _, grid) in chip_smoke.MP_PATHS.items()}


def _rank(index: int, store: str, out_path: str, labels: list) -> None:
    from cvnets_tpu_torch.parallel import mesh

    torch.set_num_threads(2)
    chip_smoke.MP_PATHS.clear()
    chip_smoke.MP_PATHS.update({label: MICRO[label] for label in labels})
    mesh.init_group("gloo", index, 2, f"file://{store}", chip_smoke.DDP_TIMEOUT_S)
    chip_smoke.ddp_checks(labels, "CPU rehearsal", out_path, device=torch.device("cpu"))


def main(argv) -> int:
    from cvnets_tpu_torch import parallel

    labels = argv or list(MICRO)
    unknown = [label for label in labels if label not in MICRO]
    if unknown:
        print(f"rehearse_model_parallel_checks: unknown paths {unknown}; known: {list(MICRO)}",
              file=sys.stderr)
        return 2
    chip_smoke.ring_check("CPU rehearsal", device="cpu", shape=(2, 64, 4, 16))
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "gloo.json")
        parallel.spawn(_rank, 2, (os.path.join(tmp, "store"), out_path, labels),
                       timeout_s=chip_smoke.DDP_TIMEOUT_S)
        with open(out_path) as f:
            print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
