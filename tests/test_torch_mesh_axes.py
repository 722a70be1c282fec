"""The port's mesh beyond the data axis, without a process group: the
parameter layout against the JAX package's ``param_sharding`` on the
conftest's virtual 8-device mesh, the dropout mask of a head slice, the
mesh's coordinates and what stays refused.

- ``param_layout`` gives each port parameter the fsdp and tensor dims of
  ``param_sharding``'s spec for its JAX leaf (block leaves one dim down),
  leaf for leaf, on the meshes 2 × 4 × 1, 2 × 1 × 4 and 1 × 2 × 2.
- ``_keep`` with ``head_base`` and ``heads_total``: the mask of heads
  [h0, h0 + H/t) is the slice of the whole-head mask bit for bit (at a row
  base too), equals the JAX debug kernel's mask over the global batch,
  and a whole-head call keeps today's mask; the plain dropout attention
  and its gradients on a head slice equal the whole call's slice.
- ``build_mesh``: the coordinates of ``reshape(dcn, data, fsdp, tensor)``,
  the batch slot, and a group smaller than its mesh (the JAX ValueError).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chestxray_vit_tpu.config import MeshConfig, ModelConfig
from chestxray_vit_tpu.models import vit as jvit
from chestxray_vit_tpu.ops import flash_attention as jfa
from chestxray_vit_tpu.parallel import mesh as jmesh
from chestxray_vit_tpu_torch import config as tconfig
from chestxray_vit_tpu_torch.models import bridge
from chestxray_vit_tpu_torch.ops import flash_attention as tfa
from chestxray_vit_tpu_torch.parallel import fsdp
from chestxray_vit_tpu_torch.parallel import mesh as tmesh

TINY = dict(img_size=32, patch_size=16, hidden_size=64, num_layers=2,
            num_heads=4, mlp_dim=128, num_classes=5, dtype="float32",
            attention_impl="xla")
SEED, RATE = 1234, 0.1


@pytest.fixture(scope="module")
def jax_tree():
    return jvit.init_params(jax.random.key(0), ModelConfig(**TINY))


def _spec_dims(spec, ndim):
    """(fsdp dim, tensor dim) of a PartitionSpec over ``ndim`` dims."""
    names = list(spec) + [None] * (ndim - len(spec))
    return (next((i for i, a in enumerate(names) if a == "fsdp"), None),
            next((i for i, a in enumerate(names) if a == "tensor"), None))


@pytest.mark.parametrize("shape", [(2, 4, 1), (2, 1, 4), (1, 2, 2)],
                         ids=["2x4x1", "2x1x4", "1x2x2"])
def test_param_layout_equals_jax_param_sharding(shape, jax_tree):
    data, f, t = shape
    n = data * f * t
    jm = jmesh.build_mesh(MeshConfig(data=data, fsdp=f, tensor=t),
                          devices=jax.devices()[:n])
    shardings = jmesh.param_sharding(jm, jax_tree)
    tm = tmesh.build_mesh(tconfig.MeshConfig(data=data, fsdp=f, tensor=t),
                          world=n, rank=0)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jax_tree),
                                    tconfig.ModelConfig(**TINY))
    layout = tmesh.param_layout(tm, params)
    assert set(layout.dims) == {n for n, _ in params.named_parameters()}
    sharded = 0
    for name in layout.dims:
        parts = name.split(".")
        node = shardings["blocks"] if parts[0] == "blocks" else shardings
        for p in (parts[2:] if parts[0] == "blocks" else parts):
            node = node[p]
        leaf = jax_tree
        for p in ([parts[0]] + parts[2:] if parts[0] == "blocks" else parts):
            leaf = leaf[p]
        fd, td = _spec_dims(node.spec, leaf.ndim)
        if parts[0] == "blocks":
            assert fd != 0 and td != 0
            fd = None if fd is None else fd - 1
            td = None if td is None else td - 1
        assert layout.dims[name] == (fd, td), name
        sharded += layout.dims[name] != (None, None)
    assert sharded > 0
    # JAX's own pins: mlp_in's kernel is fsdp-sharded; q columns and wo
    # rows are tensor-split
    if f > 1:
        assert layout.dims["blocks.0.mlp_in.kernel"][0] is not None
    if t > 1:
        assert layout.dims["blocks.1.wq.kernel"][1] == 1
        assert layout.dims["blocks.1.wo.kernel"][1] == 0
        assert layout.dims["blocks.1.wq.bias"][1] == 0


def test_local_slices_rebuild_the_full_tree(jax_tree):
    """Every rank's shards of a 1 × 2 × 2 layout, joined along the layout's
    dims, give the full tensors back."""
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jax_tree),
                                    tconfig.ModelConfig(**TINY))
    layouts = [tmesh.param_layout(tmesh.build_mesh(
        tconfig.MeshConfig(data=1, fsdp=2, tensor=2), world=4, rank=r),
        params) for r in range(4)]
    for name, p in params.named_parameters():
        fd, td = layouts[0].dims[name]
        shards = [fsdp.local_slice(lay, name, p.detach())
                  for lay in layouts]
        assert all(s.shape[i] * (2 if i in (fd, td) else 1) == p.shape[i]
                   for s in shards for i in range(p.dim()))
        rows = []
        for fi in range(2):        # rank = fsdp * 2 + tensor
            part = [shards[fi * 2 + ti] for ti in range(2)]
            rows.append(torch.cat(part, td) if td is not None else part[0])
        full = torch.cat(rows, fd) if fd is not None else rows[0]
        assert torch.equal(full, p.detach()), name


def test_tensor_split_needs_whole_heads():
    params = bridge.params_from_jax(
        jax.tree.map(np.asarray, jvit.init_params(
            jax.random.key(0), ModelConfig(**{**TINY, "num_heads": 2}))),
        tconfig.ModelConfig(**{**TINY, "num_heads": 2}))
    mesh = tmesh.build_mesh(tconfig.MeshConfig(data=1, tensor=4), world=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #15"):
        tmesh.param_layout(mesh, params)


# ---------------------------------------------------------------------------
# The dropout mask of a head slice
# ---------------------------------------------------------------------------

def _qkv(seed, shape=(3, 4, 77, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("row_base", [0, 5])
@pytest.mark.parametrize("block_q", [128, 32], ids=["single-block",
                                                    "multi-block"])
def test_head_slice_mask_is_the_global_slice(t, row_base, block_q):
    q = torch.zeros(3, 4, 77, 64)
    whole = tfa._keep(q, SEED, RATE, block_q, row_base)
    assert torch.equal(whole, tfa._keep(q, SEED, RATE, block_q, row_base,
                                        0, None))
    h = 4 // t
    for r in range(t):
        part = tfa._keep(q[:, r * h:(r + 1) * h], SEED, RATE, block_q,
                         row_base, head_base=r * h, heads_total=4)
        assert torch.equal(part, whole[:, r * h:(r + 1) * h])
    # the packed mask's strides take the same head fields
    whole = tfa._packed_keep(q, SEED, RATE, block_q, row_base)
    part = tfa._packed_keep(q[:, 2:], SEED, RATE, block_q, row_base, 2, 4)
    assert torch.equal(part, whole[:, 2:])


def test_whole_head_mask_is_unchanged():
    """A whole-head call hashes today's counter: keep_mask over B·H rows at
    bh_base = row_base · H."""
    q = torch.zeros(3, 4, 77, 64)
    q_pad, s_pad = tfa.mask_strides(77, 128)
    want = tfa.keep_mask(12, q_pad, s_pad, SEED, RATE, bh_base=7 * 4)
    want = want[:, :77, :77].reshape(3, 4, 77, 77)
    assert torch.equal(tfa._keep(q, SEED, RATE, 128, 7), want)


def test_head_slice_mask_equals_jax_global_mask():
    """A rank holding batch row 1 and heads [2, 4) of a global batch of
    3 × 4 heads: its mask is the JAX debug kernel's (interpreted) over the
    global batch, sliced."""
    q, k, v = _qkv(3)
    _, jkeep = jfa.flash_attention_dropout_debug(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([SEED], jnp.int32), RATE, None, 32)
    want = np.asarray(jkeep)[1:2, 2:4] > 0.5
    tq, tk, tv = (torch.from_numpy(x[1:2, 2:4]) for x in (q, k, v))
    _, keep = tfa.flash_attention_dropout_debug(
        tq, tk, tv, SEED, RATE, block_q=32, row_base=1, head_base=2,
        heads_total=4)
    np.testing.assert_array_equal(keep.numpy(), want)


def test_plain_dropout_attention_on_a_head_slice_equals_the_whole():
    """The dropout attention's forward and gradients (the CPU twins the
    autograd function runs) on heads [2, 4) at row base 2 equal the whole
    call's slice, bit for bit."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(4))
    o = tfa.flash_attention_dropout(q, k, v, SEED, RATE, block_q=128,
                                    row_base=2)
    do = torch.from_numpy(_qkv(5)[0])
    gq, gk, gv = torch.autograd.grad(o, (q, k, v), do)
    qs, ks, vs = (x.detach()[:, 2:].clone().requires_grad_()
                  for x in (q, k, v))
    os_ = tfa.flash_attention_dropout(qs, ks, vs, SEED, RATE, block_q=128,
                                      row_base=2, head_base=2,
                                      heads_total=4)
    g = torch.autograd.grad(os_, (qs, ks, vs), do[:, 2:])
    assert torch.equal(os_, o[:, 2:])
    for a, b in zip(g, (gq, gk, gv)):
        assert torch.equal(a, b[:, 2:])


def test_heads_outside_the_model_are_refused():
    q = torch.zeros(1, 2, 17, 64)
    with pytest.raises(ValueError, match="heads"):
        tfa._keep(q, SEED, RATE, 128, 0, head_base=3, heads_total=4)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 2, 2), (2, 1, 2, 2), (1, 8, 1, 1),
                                   (2, 2, 1, 2)])
def test_coordinates_follow_the_jax_device_order(shape):
    c, d, f, t = shape
    n = c * d * f * t
    for rank in range(n):
        m = tmesh.build_mesh(tconfig.MeshConfig(
            dcn_data=c, data=d, fsdp=f, tensor=t), world=n, rank=rank)
        want = tuple(int(i) for i in np.unravel_index(rank, shape))
        assert m.coords == want
        assert m.dp_index == rank // t
        assert tmesh.dp_size(m) == c * d * f


def test_data_axis_takes_the_rest():
    m = tmesh.build_mesh(tconfig.MeshConfig(fsdp=2, tensor=2), world=8)
    assert (m.dcn, m.data, m.fsdp, m.tensor) == (1, 2, 2, 2)
    assert tmesh.local_batch_to_global(4, m) == 16
    assert tmesh.dp_axes(m) == ("data", "fsdp")
    m = tmesh.build_mesh(tconfig.MeshConfig(dcn_data=2, fsdp=2), world=8)
    assert (m.dcn, m.data, m.fsdp) == (2, 2, 2)
    assert tmesh.dp_axes(m) == ("dcn", "data", "fsdp")


@pytest.mark.parametrize("cfg,world,shape", [
    (dict(fsdp=2), 1, "0x2x1"), (dict(tensor=2), 1, "0x1x2"),
    (dict(dcn_data=2), 1, "2x0x1x1"), (dict(data=2, fsdp=2), 2, "2x2x1")])
def test_more_devices_than_processes_refused(cfg, world, shape):
    """A group smaller than its mesh raises the JAX ``build_mesh``'s
    ValueError over its ranks (data -1 takes ``world // fixed``, here 0),
    with the hint that a lone process starts one rank a device."""
    with pytest.raises(ValueError, match=rf"mesh {shape} != {world} devices: "
                                         rf".*one rank a device"):
        tmesh.build_mesh(tconfig.MeshConfig(**cfg), world=world)


def test_a_mesh_that_does_not_tile_the_processes_raises():
    with pytest.raises(ValueError, match="processes"):
        tmesh.build_mesh(tconfig.MeshConfig(data=1, fsdp=2), world=4)
