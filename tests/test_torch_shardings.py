"""The port's sharding plan (``repro_torch.launch.{mesh, shardings,
specs}``) against the JAX package's, entry for entry.

The JAX side runs on abstract meshes (``jax.sharding.AbstractMesh``: no
devices) and on the ``FakeMesh`` stand-ins of ``tests/test_shardings.py``;
its ``NamedSharding``s are compared by their ``.spec``, a
``PartitionSpec``, with the port's spec tuples.  Every parameter leaf of
every arch at full ``CONFIG``, at 16 x 16 and 2 x 16 x 16.
"""

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro.launch import mesh as jax_mesh, shardings as jax_shardings
from repro.launch import specs as jax_specs
from repro.launch import steps as jax_steps
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro_torch.checkpoint.npz import flat_state
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import dryrun, mesh as torch_mesh, shardings, specs
from repro_torch.launch import steps as torch_steps
from repro_torch.optim import AdamWConfig

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}
    size = 256


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}
    size = 512


def _port_mesh(tag):
    return torch_mesh.make_production_mesh(multi_pod=tag == "pod2x16x16")


def _jax_mesh(tag):
    return AbstractMesh(*MESHES[tag])


def _path(path) -> str:
    return jax_shardings._path_str(path)


def _spec(sharding) -> tuple:
    return tuple(sharding.spec)


@pytest.fixture(scope="module")
def states():
    """(JAX params and opt shapes, port model and opt state on meta) by
    arch, built once."""
    out = {}
    for arch in ARCH_NAMES:
        jp, jo = jax_steps.train_state_shapes(get_config(arch),
                                              JaxAdamWConfig())
        tm, to = torch_steps.train_state_shapes(torch_config(arch),
                                                AdamWConfig())
        out[arch] = (jp, jo, tm, to)
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_mesh_shapes(tag):
    m, j = _port_mesh(tag), _jax_mesh(tag)
    assert m.axis_names == j.axis_names
    assert m.shape == dict(j.shape)
    assert m.size == j.size
    assert torch_mesh.mesh_tag(m) == tag
    assert torch_mesh.batch_axes(m) == jax_mesh.batch_axes(j)
    assert torch_mesh.n_batch_devices(m) == {"pod16x16": 16,
                                             "pod2x16x16": 32}[tag]
    debug = torch_mesh.make_debug_mesh(2, 4)
    assert debug.shape == {"data": 2, "model": 4} and debug.size == 8


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_plan_matches_jax(states, arch, tag):
    """param_spec, zero_extend, the FSDP decision, the per-device bytes and
    the param / opt shardings, leaf for leaf."""
    jp, jo, tm, to = states[arch]
    jcfg, cfg = get_config(arch), torch_config(arch)
    jmesh, mesh = _jax_mesh(tag), _port_mesh(tag)
    leaves = shardings.param_leaves(tm.named_parameters())
    jleaves = {_path(p): l for p, l in
               jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(leaves) == sorted(jleaves)
    for k, leaf in leaves.items():
        shape = tuple(leaf.shape)
        assert shape == tuple(jleaves[k].shape), k
        assert leaf.element_size() == jleaves[k].dtype.itemsize, k
        spec = shardings.param_spec(k, shape, mesh, cfg)
        assert spec == tuple(jax_shardings.param_spec(k, shape, jmesh, jcfg))
        assert shardings.zero_extend(spec, shape, mesh) == tuple(
            jax_shardings.zero_extend(P(*spec), shape, jmesh)), k
    tp_bytes = jax_shardings._tp_only_bytes_per_device(jp, jmesh, jcfg)
    assert shardings._tp_only_bytes_per_device(leaves, mesh, cfg) == tp_bytes
    assert shardings.use_fsdp(leaves, mesh, cfg) == (
        tp_bytes > jax_shardings.FSDP_THRESHOLD_BYTES)
    want = {_path(p): _spec(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jax_shardings.param_shardings(jp, jmesh, jcfg),
                is_leaf=lambda x: hasattr(x, "spec"))[0]}
    assert shardings.param_shardings(leaves, mesh, cfg) == want
    opt = shardings.opt_leaves(to)
    want = {_path(p): _spec(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jax_shardings.opt_shardings(jo, jmesh, jcfg),
                is_leaf=lambda x: hasattr(x, "spec"))[0]}
    assert shardings.opt_shardings(opt, mesh, cfg) == want


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_and_decode_state_plan_matches_jax(arch, tag):
    """batch_spec, input_shardings and decode_state_shardings at every
    shape; the dry-run's flattening of the decode plan keys the state's
    flat paths."""
    jcfg, cfg = get_config(arch), torch_config(arch)
    jmesh, mesh = _jax_mesh(tag), _port_mesh(tag)
    for name, shape in INPUT_SHAPES.items():
        port_in = specs.input_specs(cfg, shape)
        jax_in = jax_specs.input_specs(jcfg, shape)
        assert shardings.batch_shardings(port_in, mesh) == {
            k: _spec(s) for k, s in
            jax_shardings.batch_shardings(jax_in, jmesh).items()}, name
        assert specs.input_shardings(port_in, mesh) == {
            k: _spec(s) for k, s in
            jax_specs.input_shardings(jax_in, jmesh).items()}, name
        if shape.kind != "decode":
            continue
        want = jax.tree.map(_spec, jax_specs.decode_state_shardings(
            jcfg, shape, jmesh), is_leaf=lambda x: hasattr(x, "spec"))
        got = specs.decode_state_shardings(cfg, shape, mesh)
        assert got == want, name
        state = specs.decode_state_specs(cfg, shape)
        flat = dryrun._flat_specs(state, got)
        assert sorted(flat) == sorted(flat_state(state))


@pytest.mark.parametrize("mesh_cls", [FakeMesh, FakePodMesh])
def test_pure_functions_on_fake_meshes(mesh_cls):
    """batch_spec and maybe over assorted dims and axes, and the rules of
    tests/test_shardings.py, on the FakeMesh stand-ins."""
    mesh = mesh_cls()
    for dims in [(256, 4096), (1, 4096), (128,), (32, 32768, 4096), (0, 3),
                 (512, 1), (16, 2), ()]:
        assert shardings.batch_spec(dims, mesh) == tuple(
            jax_shardings.batch_spec(dims, mesh)), dims
    for axes in ["data", "model", "pod", ("pod", "data"), ("data", "model")]:
        for dim in [0, 1, 2, 16, 24, 32, 128, 512, 4097]:
            assert shardings.maybe(axes, dim, mesh) == \
                jax_shardings.maybe(axes, dim, mesh), (axes, dim)
    for path, shape in [("layers/attn/wq/w", (40, 4096, 4096)),
                        ("layers/mlp/wo", (40, 13696, 4096)),
                        ("layers/moe/wi", (94, 128, 4096, 1536)),
                        ("embed/table", (151655, 896)),
                        ("layers/ln1/scale", (40, 4096)),
                        ("slstm/r", (3, 4, 192, 768))]:
        for cfg_name in (None, "granite-34b", "deepseek-moe-16b"):
            jcfg = cfg_name and get_config(cfg_name)
            tcfg = cfg_name and torch_config(cfg_name)
            assert shardings.param_spec(path, shape, mesh, tcfg) == tuple(
                jax_shardings.param_spec(path, shape, mesh, jcfg))


def test_bytes_per_device_rounds_each_leaf_down():
    """Each leaf's bytes over the devices it is split over, rounded down,
    as _tp_only_bytes_per_device counts them."""
    import torch
    mesh = torch_mesh.make_production_mesh()
    leaves = {"a": torch.empty((17, 32), dtype=torch.float32, device="meta"),
              "b": torch.empty((3,), dtype=torch.bfloat16, device="meta")}
    specs_ = {"a": (None, "model"), "b": ("data",)}
    assert shardings.bytes_per_device(leaves, specs_, mesh) == \
        17 * 32 * 4 // 16 + 6 // 16
