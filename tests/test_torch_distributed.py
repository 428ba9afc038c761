"""The port's data parallelism against the JAX package's one program over the
global batch: two gloo processes on the CPU (``cvnets_tpu_torch.parallel``),
each with its half of every batch, held against the JAX function on the whole
batch in float32.

One spawn of two ranks (over a ``file://`` store in ``tmp_path``, with a
timeout: a hung rank fails the test) runs every port computation of this file
and writes each rank's results; the tests compare them with JAX's:

* synced BatchNorm: the train-mode logits and running statistics of micro
  MobileViTv2 and ResNet-18 with ``batch_norm`` and ``sync_batch_norm`` (every
  train-mode BN takes the global batch's statistics; JAX's jit computes them
  so for both names);
* three AdamW steps of micro MobileViTv2 with ``--common.accum-freq 2``
  (``test_torch_train_step``'s flags and bounds, stated there for
  micro-batches of 8: here batches of 16 in two micro-batches, each rank's
  micro-batches its rows of JAX's, the gradients crossing the ranks once, after
  the last), the parameters bit-identical on the two ranks;
* the losses that divide by a count over the batch, with their gradients:
  the segmentation CE on both routes (logits at the labels' size, and the
  fused resize + CE's plain twin) with class weights, SSD's multibox loss,
  Mask R-CNN's RoI classifier, box and mask losses, and CLIP's contrastive
  loss through the differentiable all-gather. A rank's gradient, over the
  world size, is JAX's for its rows (the gradients are averaged over ranks);
* the epoch metrics over an odd validation set (15 samples, 4 a rank a
  batch), which count each sample once: top-1, top-5, mIoU, the retrieval
  metrics, average precision, the confusion matrix and the probability
  histogram;
* sample-efficient training: the ids both ranks drop are those JAX's
  ``find_easy_samples`` drops on the whole set.

MoE in a group is test_torch_fsdp's and test_torch_model_parallel_grid's.
"""

from __future__ import annotations

import collections
import functools
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    SMALL_MODEL_ARGS,
    nchw,
    seg_targets,
)

WORLD = 2
SPAWN_TIMEOUT_S = 240
RESNET_ARGS = ["--model.classification.name", "resnet", "--model.activation.name", "relu",
               "--model.classification.resnet.depth", "18", *CONV_FAMILY_ARGS]
BN_CASES = {  # name: (flags, image side)
    "mobilevit_v2/batch_norm": (SMALL_MODEL_ARGS, 64),
    "mobilevit_v2/sync_batch_norm": (
        SMALL_MODEL_ARGS + ["--model.normalization.name", "sync_batch_norm"], 64),
    "resnet18/batch_norm": (RESNET_ARGS, 32),
    "resnet18/sync_batch_norm": (
        RESNET_ARGS + ["--model.normalization.name", "sync_batch_norm"], 32),
}
BN_BATCH = 8
SEG_CLASSES, SSD_CLASSES = 5, 4
N_VAL, VAL_BATCH = 15, 4  # an odd set: rank 1's last batch holds 3 samples and a pad
EASY_N = 40
METRIC_NAMES = ["top1(pred=logits,target=cls)", "top5(pred=logits,target=cls)",
                "iou(pred=seg,target=mask)", "retrieval_cmc(pred=emb,target=cls)",
                "image_text_retrieval", "average_precision(pred=logits,target=cls)",
                "confusion_matrix(pred=logits,target=cls)", "prob_hist(pred=logits,target=cls)"]
METRIC_ARGS = ["--model.segmentation.n-classes", str(SEG_CLASSES),
               "--dataset.val-batch-size0", str(VAL_BATCH)]


# ------------------------------------------------------------ the two ranks
def _rank_main(index: int, store: str, inputs: str, out_dir: str) -> None:
    from cvnets_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_group("gloo", index, WORLD, f"file://{store}", timeout_s=SPAWN_TIMEOUT_S)
    try:
        data = torch.load(inputs, weights_only=False)
        torch.save(_suite(index, data), os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        mesh.destroy_group()


def _shard(t, rank: int):
    n = t.shape[0] // WORLD
    return t[rank * n:(rank + 1) * n]


def _port_model(args, state_dict):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    model = get_model(get_training_arguments(args=list(args)), device="cpu")
    model.load_state_dict(state_dict)
    return model


def _suite(rank: int, data: dict) -> dict:
    out = {"bn": {}}
    for name, (args, _) in BN_CASES.items():
        model = _port_model(args, data["bn_state"][name.split("/")[0]]).train()
        logits = model(nchw(_shard(data["bn_x"][name], rank)))
        out["bn"][name] = {"logits": logits.detach(), "state": model.state_dict()}
    out["steps"] = _steps(rank, data["steps"])
    out["losses"] = _losses(rank, data["losses"])
    out["metrics"] = _metrics(data["metrics"])
    out["easy"] = _easy(data["easy"])
    return out


def _steps(rank: int, run: dict) -> list:
    """The port's train step on this rank's rows of each batch."""
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=list(run["args"]))
    model = _port_model(run["args"], run["state"])
    state = port.create_train_state(model, build_optimizer(opts, model), ema_enabled=True)
    step = port.make_train_step(model, build_loss_fn(opts), opts,
                                build_metrics(opts, ["loss", "grad_norm"]))
    out = []
    for x, y, lr in zip(run["xs"], run["ys"], run["lrs"]):
        rows = run["rows"][rank]
        state, metrics = step(state, {"samples": nchw(x[rows]),
                                      "targets": torch.from_numpy(y[rows])}, lr)
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    {k: v.clone() for k, v in state.ema.model.state_dict().items()},
                    metrics["loss"]["loss"][0].item(),
                    metrics["grad_norm"]["grad_norm"][0].item()))
    return out


def _losses(rank: int, data: dict) -> dict:
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models.detection.mask_rcnn import roi_box_losses, roi_mask_loss
    from cvnets_tpu_torch.options.opts import get_training_arguments

    def leaf(a):
        return _shard(torch.from_numpy(a), rank).clone().requires_grad_(
            a.dtype == np.float32)

    out = {}
    for name in ("seg_full", "seg_fused"):
        crit = build_loss_fn(get_training_arguments(args=data["seg_args"]), device="cpu")
        logits = leaf(data[name])
        loss = crit(None, logits, _shard(torch.from_numpy(data["seg_y"]), rank), training=True)
        loss.backward()
        out[name] = (loss.item(), logits.grad)
    crit = build_loss_fn(get_training_arguments(args=data["ssd_args"]), device="cpu")
    scores, boxes = leaf(data["ssd_scores"]), leaf(data["ssd_boxes"])
    loss = crit(None, {"scores": scores, "boxes": boxes},
                {"box_labels": leaf(data["ssd_labels"]),
                 "box_coordinates": leaf(data["ssd_coords"]).detach()}, training=True)
    loss.backward()
    out["ssd"] = (loss.item(), scores.grad, boxes.grad)
    r = data["roi"]
    scores, deltas, mlogits = leaf(r["scores"]), leaf(r["deltas"]), leaf(r["mask_logits"])
    box = roi_box_losses(scores, deltas, leaf(r["labels"]), leaf(r["reg_t"]).detach(),
                         leaf(r["pos"]), leaf(r["valid"]))
    mask = roi_mask_loss(mlogits, leaf(r["mask_t"]).detach(), leaf(r["m_valid"]).detach())
    (box["loss_classifier"] + box["loss_box_reg"] + mask).backward()
    out["roi"] = ({k: v.item() for k, v in box.items()}, mask.item(), scores.grad,
                  deltas.grad, mlogits.grad)
    crit = build_loss_fn(get_training_arguments(args=data["clip_args"]), device="cpu")
    image, text = leaf(data["clip_image"]), leaf(data["clip_text"])
    loss = crit(None, {"image": image, "text": text, "logit_scale": 20.0}, None,
                training=True)
    loss["total_loss"].backward()
    out["clip"] = ({k: v.item() for k, v in loss.items()}, image.grad, text.grad)
    return out


class _Table(torch.nn.Module):
    """Every output of a sample read from a table by the sample's index."""

    def __init__(self, tables: dict) -> None:
        super().__init__()
        self.tables = {k: torch.from_numpy(v) for k, v in tables.items()}

    def forward(self, samples):
        idx = samples[:, 0].long()
        return {k: v[idx] for k, v in self.tables.items()}


class _Rows:
    """A dataset whose items are their index and the targets' rows."""

    def __init__(self, targets: dict) -> None:
        self.targets = targets

    def __len__(self) -> int:
        return len(self.targets["cls"])

    def __getitem__(self, t):
        idx = t[2]
        return {"samples": torch.tensor([float(idx)]),
                "targets": {k: torch.from_numpy(np.asarray(v[idx])) for k, v in
                            self.targets.items()}}


def _metrics(data: dict) -> dict:
    from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
    from cvnets_tpu_torch.data.loader.dataloader import CVNetsDataLoader
    from cvnets_tpu_torch.data.sampler import build_sampler
    from cvnets_tpu_torch.engine.train_state import TrainState, make_eval_step
    from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, gathered_pairs
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=METRIC_ARGS)
    stats = Statistics(opts, METRIC_NAMES)
    model = _Table(data["outputs"])
    step = make_eval_step(model, lambda *a, **k: torch.zeros(()), stats.metrics)
    loader = CVNetsDataLoader(_Rows(data["targets"]),
                              build_sampler(opts, N_VAL, is_training=False),
                              collate_fn=default_collate_fn, opts=opts, device="cpu")
    pairs, seen = None, []
    for batch in loader:
        seen.append(batch.get("n_valid", VAL_BATCH))
        pairs = add_pairs(pairs, step(TrainState(model=model, optimizer=None), batch))
    stats.update(gathered_pairs(pairs))
    return {"stats": stats.avg_statistics_all(), "valid_rows": seen}


def _easy(data: dict) -> dict:
    from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
    from cvnets_tpu_torch.data.loader.dataloader import CVNetsDataLoader
    from cvnets_tpu_torch.data.sampler import build_sampler
    from cvnets_tpu_torch.engine.training_engine import Trainer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    class Images:
        def __len__(self):
            return EASY_N

        def __getitem__(self, t):
            return {"samples": torch.from_numpy(np.ascontiguousarray(
                data["x"][t[2]].transpose(2, 0, 1))),
                "targets": int(data["y"][t[2]]), "sample_id": t[2]}

    opts = get_training_arguments(args=SMALL_MODEL_ARGS + ["--dataset.train-batch-size0", "6"])
    loader = CVNetsDataLoader(Images(), build_sampler(opts, EASY_N, is_training=True),
                              collate_fn=default_collate_fn, opts=opts, device="cpu")
    trainer = types.SimpleNamespace(
        model=_port_model(SMALL_MODEL_ARGS, data["state"]), opts=opts,
        device=torch.device("cpu"),
        train_loader=loader, set_confidence=data["confidence"], _easy_counts={})
    trainer.easy_sample_ids = types.MethodType(Trainer.easy_sample_ids, trainer)
    for epoch in range(2):
        loader.batch_sampler.set_epoch(epoch)
        Trainer.find_easy_samples(trainer, epoch)
    return {"kept": loader.batch_sampler.img_indices}


# -------------------------------------------------------------- the parent
def _trajectory_inputs(variables: dict, accum: int = 2, n_steps: int = 3,
                       batch: int = 16) -> dict:
    """The batches, LRs and flags of the AdamW steps, the port's init state,
    and each rank's rows: its share of each of JAX's contiguous micro-batches."""
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from test_torch_train_step import ARGS
    from torch_port_helpers import both_opts, port_model_from

    args = list(ARGS) + ["--common.accum-freq", str(accum)]
    opts_torch = both_opts(args)[1]
    rng = np.random.default_rng(0)
    micro, per = batch // accum, batch // accum // WORLD
    return {"args": args, "variables": variables,
            "state": port_model_from(opts_torch, variables).state_dict(),
            "xs": [rng.integers(0, 256, (batch, 64, 64, 3)).astype(np.uint8)
                   for _ in range(n_steps)],
            "ys": [rng.integers(0, 13, (batch,)) for _ in range(n_steps)],
            "lrs": [build_scheduler(opts_torch).retrieve_lr(0, i) for i in range(n_steps)],
            "rows": [np.concatenate([np.arange(i * micro + r * per, i * micro + (r + 1) * per)
                                     for i in range(accum)]) for r in range(WORLD)]}


def _jax_trajectory(run: dict) -> list:
    """JAX's train step on the whole batches from the same init (as
    test_torch_train_step's)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from test_torch_train_step import _LossAndNorm
    from torch_port_helpers import both_opts

    opts_jax = both_opts(run["args"])[0]
    jmodel, variables = get_model(opts_jax), run["variables"]
    tx = build_optimizer(opts_jax)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jnp.zeros((1, 64, 64, 3))}, ema_enabled=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables.get("batch_stats", {}))
    state = state.replace(params=params, batch_stats=stats, ema_params=params,
                          ema_batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax,
                                    {"out": _LossAndNorm()}))
    out = []
    for x, y, lr in zip(run["xs"], run["ys"], run["lrs"]):
        state, metrics = jstep(state, {"samples": jnp.asarray(x), "targets": jnp.asarray(y)},
                               lr, jax.random.PRNGKey(0))
        out.append((state, *[float(v) for v in metrics["out"]]))
    return out


def _bn_inputs() -> tuple:
    from cvnets_tpu.models import get_model
    from torch_port_helpers import both_opts, perturbed_variables, port_model_from

    rng = np.random.default_rng(1)
    x, states, variables = {}, {}, {}
    for name, (args, side) in BN_CASES.items():
        x[name] = rng.random((BN_BATCH, side, side, 3), dtype=np.float32)
        family = name.split("/")[0]
        if family not in states:
            opts_jax, opts_torch = both_opts(args)
            variables[family] = perturbed_variables(get_model(opts_jax), x[name][:2])
            states[family] = port_model_from(opts_torch, variables[family]).state_dict()
    return x, states, variables


def _loss_inputs() -> dict:
    rng = np.random.default_rng(2)
    b = 4
    roi_n, roi_c, m = 6, 5, 3
    labels = rng.integers(0, roi_c, (b, roi_n))
    return {
        "seg_args": ["--loss.category", "segmentation",
                     "--loss.segmentation.cross-entropy.class-weights",
                     "--loss.segmentation.cross-entropy.label-smoothing", "0.1"],
        "seg_full": rng.standard_normal((b, SEG_CLASSES, 16, 16)).astype(np.float32),
        "seg_fused": rng.standard_normal((b, SEG_CLASSES, 4, 4)).astype(np.float32),
        # rank 1's rows hold most of the ignored pixels: the counts differ
        "seg_y": np.concatenate([seg_targets(rng, 2, 16, SEG_CLASSES),
                                 np.where(rng.random((2, 16, 16)) < 0.5, 255,
                                          rng.integers(0, SEG_CLASSES, (2, 16, 16)))]),
        "ssd_args": ["--loss.category", "detection", "--loss.detection.name",
                     "ssd_multibox_loss"],
        "ssd_scores": rng.standard_normal((b, 30, SSD_CLASSES)).astype(np.float32),
        "ssd_boxes": rng.standard_normal((b, 30, 4)).astype(np.float32),
        "ssd_labels": np.where(rng.random((b, 30)) < [[0.1], [0.2], [0.4], [0.05]],
                               rng.integers(1, SSD_CLASSES, (b, 30)), 0),
        "ssd_coords": rng.standard_normal((b, 30, 4)).astype(np.float32),
        "roi": {"scores": rng.standard_normal((b, roi_n, roi_c)).astype(np.float32),
                "deltas": rng.standard_normal((b, roi_n, roi_c, 4)).astype(np.float32),
                "labels": labels,
                "reg_t": rng.standard_normal((b, roi_n, 4)).astype(np.float32),
                "pos": (labels > 0) & (rng.random((b, roi_n)) < [[0.9], [0.2], [0.5], [0.6]]),
                "valid": rng.random((b, roi_n)) < [[0.9], [0.4], [1.0], [0.7]],
                "mask_logits": rng.standard_normal((b, m, 28, 28)).astype(np.float32),
                "mask_t": rng.random((b, m, 28, 28)).astype(np.float32),
                "m_valid": (rng.random((b, m)) < [[1.0], [0.3], [0.6], [0.0]]
                            ).astype(np.float32)},
        "clip_args": ["--loss.category", "multi_modal_image_text"],
        "clip_image": _unit_rows(rng, (b, 8)),
        "clip_text": _unit_rows(rng, (b, 8)),
    }


def _unit_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _metric_inputs() -> dict:
    rng = np.random.default_rng(3)
    cls = rng.integers(0, 13, N_VAL)
    return {"outputs": {"logits": rng.standard_normal((N_VAL, 13)).astype(np.float32),
                        "seg": rng.standard_normal((N_VAL, SEG_CLASSES, 4, 4)).astype(
                            np.float32),
                        "emb": rng.standard_normal((N_VAL, 6)).astype(np.float32),
                        "image": _unit_rows(rng, (N_VAL, 6)),
                        "text": _unit_rows(rng, (N_VAL, 6))},
            "targets": {"cls": cls, "mask": rng.integers(0, SEG_CLASSES, (N_VAL, 4, 4))}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the two ranks' results, and JAX's train steps (run while
    the ranks run)."""
    from cvnets_tpu_torch import parallel
    from torch_port_helpers import torch_threads

    tmp = tmp_path_factory.mktemp("distributed")
    with torch_threads(2):
        bn_x, bn_state, bn_vars = _bn_inputs()
        steps = _trajectory_inputs(bn_vars["mobilevit_v2"])
        data = {"bn_x": bn_x, "bn_state": bn_state,
                "steps": {k: v for k, v in steps.items() if k != "variables"},
                "losses": _loss_inputs(), "metrics": _metric_inputs(),
                "easy": _easy_inputs(bn_vars["mobilevit_v2"], bn_state["mobilevit_v2"])}
        torch.save(data, tmp / "inputs.pt")
        ranks = parallel.spawn(_rank_main, WORLD, (str(tmp / "store"), str(tmp / "inputs.pt"),
                                                   str(tmp)), timeout_s=SPAWN_TIMEOUT_S,
                               join=False)
        jax_steps = _jax_trajectory(steps)
        one_process = _steps(0, {**data["steps"], "lrs": steps["lrs"][:1],
                                 "rows": [np.arange(len(steps["ys"][0]))]})
        ranks.join()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"data": data, "bn_vars": bn_vars, "steps": {"lrs": steps["lrs"], "jax": jax_steps},
            "one_process": one_process, "ranks": ranks}


def _easy_inputs(variables: dict, state: dict) -> dict:
    """40 images whose targets are JAX's predicted class for the first 24 (the
    others get another class), and a confidence between two of those 24's
    true-class probabilities, so that some pass and some do not."""
    import jax

    from cvnets_tpu.models import get_model
    from torch_port_helpers import both_opts

    rng = np.random.default_rng(4)
    x = rng.random((EASY_N, 64, 64, 3), dtype=np.float32)
    jmodel = get_model(both_opts(SMALL_MODEL_ARGS)[0])
    logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(
        variables, x))
    pred = logits.argmax(-1)
    y = np.where(np.arange(EASY_N) < 24, pred, (pred + 1) % 13)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p_true = np.sort((e / e.sum(-1, keepdims=True))[np.arange(24), pred[:24]])
    gaps = np.diff(p_true)
    i = 4 + int(np.argmax(gaps[4:-4]))  # the widest gap away from both ends
    return {"x": x, "y": y, "state": state, "variables": variables,
            "confidence": float((p_true[i] + p_true[i + 1]) / 2)}


# ----------------------------------------------------------------- the tests
@functools.lru_cache(maxsize=None)
def _jax_train_forward(family: str):
    """JAX's jitted train forward of a family. Its ``sync_batch_norm`` builds the
    same module as ``batch_norm`` (cvnets_tpu/layers/normalization.py:171-178),
    so one model serves both names."""
    import jax

    from cvnets_tpu.models import get_model
    from torch_port_helpers import both_opts

    jmodel = get_model(both_opts(BN_CASES[f"{family}/batch_norm"][0])[0])
    return jax.jit(lambda v, x: jmodel.apply(v, x, training=True, mutable=["batch_stats"]))


@pytest.mark.parametrize("name", list(BN_CASES))
def test_synced_batch_norm_gives_the_global_batch_outputs_and_stats(runs, name):
    import jax
    import jax.numpy as jnp

    from torch_port_helpers import LOGIT_ATOL, assert_stats_match

    args, _ = BN_CASES[name]
    family = name.split("/")[0]
    variables, x = runs["bn_vars"][family], runs["data"]["bn_x"][name]
    got = [r["bn"][name] for r in runs["ranks"]]
    logits = torch.cat([g["logits"] for g in got]).numpy()
    for key, value in got[0]["state"].items():  # both ranks hold the global statistics
        assert torch.equal(value, got[1]["state"][key]), key
    # against one process of the port on the whole batch: float32 sums in
    # another order, nothing more
    one = _port_model(args, runs["data"]["bn_state"][family]).train()
    want = one(nchw(x)).detach().numpy()
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    for key, value in one.state_dict().items():
        np.testing.assert_allclose(got[0]["state"][key].numpy(), value.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(value.abs().max())),
                                   err_msg=key)
    # against JAX: the model tests' bounds for the statistics; the logits at
    # twice theirs, since one process of the port sits up to 1.23e-4 from JAX's
    # on these batches of 8 (measured; LOGIT_ATOL is 1e-4)
    jlogits, new = _jax_train_forward(family)(variables, jnp.asarray(x))
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0,
                               atol=2 * LOGIT_ATOL * max(1.0, float(np.abs(jlogits).max())))
    assert_stats_match(got[0]["state"], jax.tree_util.tree_map(np.asarray,
                                                               new["batch_stats"]))


def test_three_adamw_steps_with_accumulation_match_jax_on_the_global_batch(runs):
    from test_torch_train_step import _check_three_steps, _pairs

    ranks = [r["steps"] for r in runs["ranks"]]
    for step in range(3):  # the same bits on both ranks, parameters, EMA and buffers
        for sd0, sd1 in ((ranks[0][step][0], ranks[1][step][0]),
                         (ranks[0][step][1], ranks[1][step][1])):
            for key, value in sd0.items():
                assert torch.equal(value, sd1[key]), (step, key)
        assert ranks[0][step][3] == ranks[1][step][3]  # the grad norm after the average
    # the loss of a step is its last micro-batch's, as in JAX; each rank's is the
    # mean over its half of it, and their mean the global one
    torch_side = [(sd, ema, (ranks[0][i][2] + ranks[1][i][2]) / 2, norm)
                  for i, (sd, ema, _, norm) in enumerate(ranks[0])]
    # against one process of the port on the whole batches: the same first step
    # but for the order of float32 sums (after it, the Adam sign flips that
    # order brings part the trajectories as JAX's and the port's part)
    (_, _, loss, norm), (_, _, loss1, norm1) = torch_side[0], runs["one_process"][0]
    assert loss == pytest.approx(loss1, abs=1e-6)
    assert norm == pytest.approx(norm1, rel=1e-5)
    # against JAX: test_torch_train_step's first-step checks, but the grad norm
    # at 2e-3, since one process of the port sits 1.09e-3 from JAX's at this
    # first step (measured; 2.2e-4 and 1.4e-2 at the next two, within the
    # three-step bound of 2e-2)
    (state, jloss, jnorm), (sd, ema_sd, loss, norm) = runs["steps"]["jax"][0], torch_side[0]
    lr = runs["steps"]["lrs"][0]
    assert loss == pytest.approx(jloss, abs=1e-5)
    assert norm == pytest.approx(jnorm, rel=2e-3)
    for key, want, got in _pairs(state.batch_stats, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max(),
                                   err_msg=key)
    # Adam's first step is ±lr an element: a flipped sign moves it by 2·lr,
    # plus the float32 rounding of a parameter of a few units (measured
    # 2.0003·lr at most, and 0.20027·lr in the EMA's tenth of the step)
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in _pairs(state.params, sd)])
    assert diffs.max() <= 2.001 * lr and np.mean(diffs > 1e-2 * lr) < 0.01
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in _pairs(state.ema_params, ema_sd)])
    assert diffs.max() <= 0.201 * lr and np.mean(diffs > 1e-3 * lr) < 0.01  # a tenth
    _check_three_steps({**runs["steps"], "torch": torch_side})


def _assert_grad(got_by_rank, want, what):
    """The ranks' gradients over the world size (the average the gradient
    sync takes), concatenated, against JAX's gradient on the whole batch:
    float32 sums over at most a few thousand terms."""
    got = torch.cat(list(got_by_rank)).numpy() / WORLD
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=what)


def _loss_mean(values) -> float:
    return sum(values) / WORLD


@pytest.mark.parametrize("route", ["seg_full", "seg_fused"])
def test_segmentation_ce_divides_by_the_global_count(runs, route):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.options.opts import get_training_arguments

    data = runs["data"]["losses"]
    crit = build_loss_fn(get_training_arguments(args=data["seg_args"]))
    y = jnp.asarray(data["seg_y"])
    loss, grad = jax.jit(jax.value_and_grad(
        lambda lg: crit(None, jnp.transpose(lg, (0, 2, 3, 1)), y, training=True)))(
        jnp.asarray(data[route]))
    got = [r["losses"][route] for r in runs["ranks"]]
    assert _loss_mean(g[0] for g in got) == pytest.approx(float(loss), rel=1e-5)
    _assert_grad((g[1] for g in got), grad, route)


def test_ssd_loss_divides_by_the_global_positives(runs):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.options.opts import get_training_arguments

    data = runs["data"]["losses"]
    crit = build_loss_fn(get_training_arguments(args=data["ssd_args"]))
    target = {"box_labels": jnp.asarray(data["ssd_labels"]),
              "box_coordinates": jnp.asarray(data["ssd_coords"])}
    loss, (gs, gb) = jax.jit(jax.value_and_grad(
        lambda s, b: crit(None, {"scores": s, "boxes": b}, target, training=True),
        argnums=(0, 1)))(jnp.asarray(data["ssd_scores"]), jnp.asarray(data["ssd_boxes"]))
    got = [r["losses"]["ssd"] for r in runs["ranks"]]
    assert _loss_mean(g[0] for g in got) == pytest.approx(float(loss), rel=1e-5)
    _assert_grad((g[1] for g in got), gs, "scores")
    _assert_grad((g[2] for g in got), gb, "boxes")


def _jax_roi_losses(r, scores, deltas, mask_logits):
    """cvnets_tpu/models/detection/mask_rcnn.py:310-321 and 364-372, the RoI
    losses of the JAX model's ``_roi_heads`` on the whole batch."""
    import jax.numpy as jnp
    import optax

    from cvnets_tpu.models.detection.mask_rcnn import _smooth_l1

    s_labels, s_valid = jnp.asarray(r["labels"]), jnp.asarray(r["valid"], jnp.float32)
    s_pos = jnp.asarray(r["pos"], jnp.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(scores, s_labels)
    cls_loss = jnp.sum(ce * s_valid) / jnp.maximum(jnp.sum(s_valid), 1.0)
    sel = jnp.take_along_axis(deltas, s_labels[..., None, None].clip(0).repeat(4, -1),
                              axis=2).squeeze(2)
    reg = jnp.sum(_smooth_l1(sel, jnp.asarray(r["reg_t"])), axis=-1)
    reg_loss = jnp.sum(reg * s_pos) / jnp.maximum(jnp.sum(s_pos), 1.0)
    ls = optax.sigmoid_binary_cross_entropy(
        mask_logits, (jnp.asarray(r["mask_t"]) > 0.5).astype(jnp.float32))
    valid_f = jnp.asarray(r["m_valid"]).reshape(-1)
    per_roi = jnp.mean(ls.reshape((-1,) + ls.shape[2:]), axis=(1, 2))
    mask = jnp.sum(per_roi * valid_f) / jnp.maximum(jnp.sum(valid_f), 1.0)
    return cls_loss, reg_loss, mask


def test_mask_rcnn_roi_losses_divide_by_the_global_counts(runs):
    import jax
    import jax.numpy as jnp

    r = runs["data"]["losses"]["roi"]
    inputs = [jnp.asarray(r[k]) for k in ("scores", "deltas", "mask_logits")]
    (_, (cls_loss, reg_loss, mask)), grads = jax.jit(jax.value_and_grad(
        lambda *a: (sum(_jax_roi_losses(r, *a)), _jax_roi_losses(r, *a)),
        argnums=(0, 1, 2), has_aux=True))(*inputs)
    got = [rk["losses"]["roi"] for rk in runs["ranks"]]
    assert _loss_mean(g[0]["loss_classifier"] for g in got) == pytest.approx(
        float(cls_loss), rel=1e-5)
    assert _loss_mean(g[0]["loss_box_reg"] for g in got) == pytest.approx(
        float(reg_loss), rel=1e-5)
    assert _loss_mean(g[1] for g in got) == pytest.approx(float(mask), rel=1e-5)
    for i, what in ((2, "scores"), (3, "deltas"), (4, "mask logits")):
        _assert_grad((g[i] for g in got), grads[i - 2], what)


def test_contrastive_loss_gathers_the_global_batch(runs):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.options.opts import get_training_arguments

    data = runs["data"]["losses"]
    crit = build_loss_fn(get_training_arguments(args=data["clip_args"]))

    def total(image, text):
        out = crit(None, {"image": image, "text": text, "logit_scale": 20.0}, None,
                   training=True)
        return out["total_loss"], out

    (loss, parts), (gi, gt) = jax.jit(jax.value_and_grad(total, argnums=(0, 1),
                                                         has_aux=True))(
        jnp.asarray(data["clip_image"]), jnp.asarray(data["clip_text"]))
    got = [r["losses"]["clip"] for r in runs["ranks"]]
    for key in ("total_loss", "image_loss", "text_loss"):
        assert _loss_mean(g[0][key] for g in got) == pytest.approx(float(parts[key]),
                                                                   rel=1e-5), key
    _assert_grad((g[1] for g in got), gi, "image")
    _assert_grad((g[2] for g in got), gt, "text")


def test_epoch_metrics_count_each_sample_of_an_odd_set_once(runs):
    from cvnets_tpu.metrics import build_metrics
    from cvnets_tpu.options.opts import get_training_arguments

    data = runs["data"]["metrics"]
    # rank 0 holds 8 samples, rank 1 seven and the pad that evens them out
    assert [r["metrics"]["valid_rows"] for r in runs["ranks"]] == [[4, 4], [4, 3]]
    want = {}
    for name, metric in build_metrics(get_training_arguments(args=METRIC_ARGS),
                                      METRIC_NAMES).items():
        if name == "iou":  # JAX's takes NHWC logits and no keys
            metric.update_values(metric.batch_values(
                data["outputs"]["seg"].transpose(0, 2, 3, 1), data["targets"]["mask"]))
        else:
            metric.update(data["outputs"], data["targets"])
        value = metric.compute()
        if isinstance(value, dict):
            want.update({k if k.startswith(name) else f"{name}.{k}": v
                         for k, v in value.items()})
        else:
            want[name] = value
    for r in runs["ranks"]:
        got = r["metrics"]["stats"]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(float(value), rel=1e-5, abs=1e-5), key


def test_sample_efficient_training_drops_the_jax_ids_on_every_rank(runs):
    import jax.numpy as jnp

    from cvnets_tpu.engine.training_engine import Trainer
    from cvnets_tpu.models import get_model
    from torch_port_helpers import both_opts

    data = runs["data"]["easy"]

    class Loader(list):
        batch_sampler = types.SimpleNamespace(img_indices=None, n_data_samples=EASY_N)

        def update_indices(self, keep):
            self.batch_sampler.img_indices = keep

    loader = Loader([{"samples": jnp.asarray(data["x"]), "targets": jnp.asarray(data["y"]),
                      "sample_id": np.arange(EASY_N)}])
    variables = data["variables"]
    stub = types.SimpleNamespace(
        model=get_model(both_opts(SMALL_MODEL_ARGS)[0]), train_loader=loader,
        state=collections.namedtuple("State", "params batch_stats")(
            variables["params"], variables["batch_stats"]),
        _easy_counts={}, set_confidence=data["confidence"], is_master_node=True)
    for epoch in range(2):
        Trainer.find_easy_samples(stub, epoch)
    want = loader.batch_sampler.img_indices
    assert want is not None and 16 <= len(want) < EASY_N - 4
    for r in runs["ranks"]:
        assert r["easy"]["kept"] == want
