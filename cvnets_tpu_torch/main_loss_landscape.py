"""Loss landscape of the port (counterpart of main_loss_landscape.py):

    python -m cvnets_tpu_torch.main_loss_landscape --common.config-file <yaml> \
        [--loss-landscape.n-points 11] [--loss-landscape.min-x -1] ...

two random directions over the model's parameters, each filter-normalized
(every tensor scaled to its parameter's norm, as the JAX package does), drawn
from a ``torch.Generator`` seeded with ``common.seed``; the loss of the model's
eval forward at ``θ + α d1 + β d2`` on a seeded dummy batch of 4 at the
config's crop size, over the (n × n) grid of α in [min-x, max-x] and β in
[min-y, max-y]; the grid in ``<results_loc>/<run_label>/loss_landscape.json``
and, where matplotlib is installed, contour and surface plots beside it. The
model keeps its initial weights, as in JAX, and runs on ``device``, the CUDA
card unless the caller asks for the CPU. ``loss_grid`` takes the directions
as arguments, so that a test can pass in JAX's.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from cvnets_tpu_torch.main_train import device_setup
from cvnets_tpu_torch.options.opts import get_loss_landscape_args
from cvnets_tpu_torch.utils import logger


def filter_normalized_direction(params: Dict[str, torch.Tensor],
                                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A normal draw (float32, on the generator's device, then moved to each
    parameter's) scaled to each parameter's norm (JAX
    ``generate_filter_normalized_direction``)."""
    out = {}
    for name, p in params.items():
        d = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device).to(p.device)
        out[name] = d * (p.detach().float().norm() / torch.clamp_min(d.norm(), 1e-10))
    return out


@torch.no_grad()
def loss_grid(model: torch.nn.Module, criteria, samples: torch.Tensor, targets: torch.Tensor,
              d1: Dict[str, torch.Tensor], d2: Dict[str, torch.Tensor],
              xs: np.ndarray, ys: np.ndarray, opts=None) -> np.ndarray:
    """grid[i, j] = the eval loss at params + xs[i]·d1 + ys[j]·d2 (the model's
    buffers as they are), under ``opts``' autocast."""
    from cvnets_tpu_torch.layers.dtype_utils import autocast

    model.eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    grid = np.zeros((len(xs), len(ys)))
    for i, a in enumerate(xs):
        for j, b in enumerate(ys):
            moved = {k: w + float(a) * d1[k] + float(b) * d2[k] for k, w in params.items()}
            with autocast(opts, samples.device):
                pred = functional_call(model, {**moved, **buffers}, (samples,))
                loss = criteria(samples, pred, targets, training=False)
            loss = loss["total_loss"] if isinstance(loss, dict) else loss
            grid[i, j] = float(loss)
        logger.info(f"loss landscape row {i + 1}/{len(xs)} done")
    return grid


def dummy_batch(opts, batch: int, device) -> tuple:
    """A seeded normal batch at the config's crop size and its labels."""
    from cvnets_tpu_torch.main_conversion import crop_size

    rng = np.random.default_rng(getattr(opts, "common.seed", 0) or 0)
    x = rng.standard_normal((batch, 3, *crop_size(opts)), dtype=np.float32)
    y = rng.integers(0, getattr(opts, "model.classification.n_classes", 1000) or 1000, batch)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def main(opts, device: Union[str, torch.device, None] = None, **kwargs) -> np.ndarray:
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model

    device = device_setup(opts, device)
    n = getattr(opts, "loss_landscape.n_points", 11)
    xs = np.linspace(getattr(opts, "loss_landscape.min_x", -1.0),
                     getattr(opts, "loss_landscape.max_x", 1.0), n)
    ys = np.linspace(getattr(opts, "loss_landscape.min_y", -1.0),
                     getattr(opts, "loss_landscape.max_y", 1.0), n)
    model = get_model(opts, device=device)
    criteria = build_loss_fn(opts, device=device)
    samples, targets = dummy_batch(opts, 4, device)
    generator = torch.Generator().manual_seed(getattr(opts, "common.seed", 0) or 0)
    params = dict(model.named_parameters())
    d1 = filter_normalized_direction(params, generator)
    d2 = filter_normalized_direction(params, generator)
    grid = loss_grid(model, criteria, samples, targets, d1, d2, xs, ys, opts=opts)

    out_dir = os.path.join(getattr(opts, "common.results_loc", "results"),
                           getattr(opts, "common.run_label", "run_1"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "loss_landscape.json")
    with open(path, "w") as f:
        json.dump({"x": xs.tolist(), "y": ys.tolist(), "loss": grid.tolist()}, f)
    logger.info(f"Saved loss landscape grid to {path}")
    render_landscape_plots(xs, ys, grid, out_dir)
    return grid


def render_landscape_plots(xs, ys, grid, out_dir: str, n_gif_frames: int = 36) -> None:
    """Contour, 3-D surface and rotating-surface gif (main_loss_landscape.py
    ``render_landscape_plots``), where matplotlib is installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import animation
    except ImportError:
        logger.warning("matplotlib unavailable; skipping landscape plots")
        return
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    fig, ax = plt.subplots(figsize=(6, 5))
    cs = ax.contour(X, Y, grid, levels=25, cmap="viridis")
    ax.clabel(cs, inline=True, fontsize=6)
    ax.set_xlabel("alpha")
    ax.set_ylabel("beta")
    fig.savefig(os.path.join(out_dir, "loss_contour.png"), dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, grid, cmap="viridis", linewidth=0, antialiased=True)
    ax.set_xlabel("alpha")
    ax.set_ylabel("beta")
    ax.set_zlabel("loss")
    fig.savefig(os.path.join(out_dir, "loss_surface.png"), dpi=150, bbox_inches="tight")

    def rotate(frame):
        ax.view_init(elev=30, azim=frame * (360.0 / n_gif_frames))
        return ()

    anim = animation.FuncAnimation(fig, rotate, frames=n_gif_frames, interval=100, blit=False)
    try:
        anim.save(os.path.join(out_dir, "loss_surface.gif"),
                  writer=animation.PillowWriter(fps=10))
        logger.info(f"Saved landscape plots to {out_dir}")
    except (OSError, RuntimeError, ValueError) as e:  # the writer varies by build
        logger.warning(f"gif render skipped: {e}")
    plt.close(fig)


def main_loss_landscape(args: Optional[List[str]] = None,
                        device: Union[str, torch.device, None] = None, **kwargs) -> np.ndarray:
    return main(get_loss_landscape_args(args=args), device=device, **kwargs)


if __name__ == "__main__":
    main_loss_landscape(sys.argv[1:])
