"""The port's layout rules (``parallel/sharding_rules.py``) against the JAX
package's ``infer_param_sharding`` (cvnets_tpu/parallel/sharding_rules.py),
leaf for leaf: on the (8)-device data mesh under FSDP and on the (4, 2)
(data, model) mesh with tensor parallelism, FSDP and both (tests/conftest.py
gives JAX 8 CPU devices), for the micro ViT and MobileNetV2 at width 0.5.

Each JAX leaf is filled with its elements' indices and placed by JAX's
sharding; each device's shard, in the port's layout (``to_torch_layout``),
must be the block ``parallel.fsdp.block`` cuts from the port's tensor at the
rank of the same place in the grid: the same elements, not only the same
shapes. The MoE stacks' expert dim shards over ``model``, the router's
outputs too."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import VIT_MICRO_ARGS, both_opts  # noqa: E402

MODELS = {
    "vit": VIT_MICRO_ARGS,
    "vit_moe": VIT_MICRO_ARGS + ["--model.classification.vit.moe-num-experts", "4",
                                 "--model.classification.vit.moe-layer-period", "2"],
    "mobilenetv2": ["--model.classification.name", "mobilenetv2",
                    "--model.classification.mobilenetv2.width-multiplier", "0.5",
                    "--model.classification.n-classes", "13",
                    "--dataset.category", "classification"],
}
MESHES = {  # name: (shape, axis names, fsdp)
    "8_fsdp": ((8,), ("data",), True),
    "4x2_tp": ((4, 2), ("data", "model"), False),
    "4x2_fsdp": ((4, 2), ("data", "model"), True),
}


def _jax_params(args):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.models import get_model

    jmodel = get_model(both_opts(args)[0])
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3))))["params"]
    return jax.tree_util.tree_map(lambda s: np.arange(int(np.prod(s.shape)), dtype=np.int32)
                                  .reshape(s.shape), shapes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("model_name", list(MODELS))
def test_port_blocks_hold_the_jax_shards_elements(model_name, mesh_name):
    import jax
    from jax.sharding import Mesh

    from cvnets_tpu.parallel.sharding_rules import infer_param_sharding
    from cvnets_tpu_torch.parallel import mesh as port_mesh
    from cvnets_tpu_torch.parallel.fsdp import block
    from cvnets_tpu_torch.parallel.sharding_rules import leaf_spec
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    shape, names, fsdp = MESHES[mesh_name]
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 CPU devices")
    devices = np.asarray(jax.devices()[:8]).reshape(shape)
    mesh = Mesh(devices, names)
    params = _jax_params(MODELS[model_name])
    shardings = infer_param_sharding(params, mesh, fsdp=fsdp)
    d, m = (shape + (1,))[:2]
    places = {dev: idx for idx, dev in np.ndenumerate(devices)}
    counts = {"model": 0, "data": 0}
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    sh_leaves = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    real = port_mesh._GRID
    try:
        for (path, leaf), sharding in zip(leaves, sh_leaves):
            path = tuple(p.key for p in path)
            name = torch_key(path)
            value = torch.from_numpy(np.ascontiguousarray(to_torch_layout(path, leaf)))
            spec = leaf_spec(name, value.shape, d, m, fsdp)
            counts["model"] += spec.model_dim is not None
            counts["data"] += spec.data_dim is not None
            placed = jax.device_put(leaf, sharding)
            for shard in placed.addressable_shards:
                idx = places[shard.device] + (0,)
                port_mesh._GRID = port_mesh.Grid(d, m, idx[0], idx[1])
                want = to_torch_layout(path, np.asarray(shard.data))
                np.testing.assert_array_equal(block(value, spec).numpy(), want,
                                              err_msg=f"{name} at {idx[:2]}")
    finally:
        port_mesh._GRID = real
    if m > 1:
        assert counts["model"] > 0
    if fsdp:
        assert counts["data"] > 0


def test_moe_stacks_and_router_shard_over_the_model_axis():
    from cvnets_tpu_torch.parallel.sharding_rules import leaf_spec

    assert leaf_spec("transformer_1.moe_ffn.experts_fc1", (4, 64, 256), 1, 2, False).model_dim == 0
    assert leaf_spec("transformer_1.moe_ffn.experts_fc2_bias", (4, 1, 64), 1, 2,
                     False).model_dim == 0
    assert leaf_spec("transformer_1.moe_ffn.router.weight", (4, 64), 1, 2, False).model_dim == 0
    # three experts do not split two ways: the stack stays whole
    assert leaf_spec("transformer_1.moe_ffn.experts_fc1", (3, 64, 256), 1, 2,
                     False).model_dim is None
