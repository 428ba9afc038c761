"""Which shipped yamls the port builds:

    python -m cvnets_tpu_torch.tools.yaml_probe [yaml ...]

For each yaml (by default every one under ``config/`` and ``examples/``): the
port's option parser, ``get_model`` (on the ``meta`` device: no weights are
drawn), ``build_scheduler``, ``build_loss_fn`` and the dataset registry's
lookup of ``dataset.name``. A checkpoint path under ``/mnt`` that a yaml
names (a teacher's, a pretrained encoder's) is cleared first: it is data,
not a part to build. Prints the first failure of each yaml that does not
build, then ``N of M yamls build``. Needs PyYAML (the yamls are read by
``options/utils.load_config_file``).
"""

from __future__ import annotations

import glob
import os
import sys
from typing import List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shipped_yamls() -> List[str]:
    return sorted(glob.glob(os.path.join(ROOT, "config", "**", "*.yaml"), recursive=True)
                  + glob.glob(os.path.join(ROOT, "examples", "**", "*.yaml"), recursive=True))


def probe(path: str) -> Optional[str]:
    """None where every part builds, else the first failure as ``Type: message``."""
    import torch

    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    try:
        opts = get_training_arguments(args=["--common.config-file", path])
        for key, value in vars(opts).items():
            if isinstance(value, str) and value.startswith("/mnt") and (
                    "pretrained" in key or "checkpoint" in key):
                setattr(opts, key, None)
        with torch.device("meta"):
            get_model(opts, device="meta")
        build_scheduler(opts)
        build_loss_fn(opts, device="meta")
        DATASET_REGISTRY[getattr(opts, "dataset.name"), getattr(opts, "dataset.category")]
    except (Exception, SystemExit) as err:  # the parser and the registries exit
        return f"{type(err).__name__}: {str(err).splitlines()[0] if str(err) else ''}"
    return None


def main(argv: List[str]) -> int:
    yamls = argv or shipped_yamls()
    n_ok = 0
    for path in yamls:
        failure = probe(path)
        if failure is None:
            n_ok += 1
        else:
            print(f"FAIL {os.path.relpath(path, ROOT)}: {failure[:200]}", flush=True)
    print(f"{n_ok} of {len(yamls)} yamls build")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
