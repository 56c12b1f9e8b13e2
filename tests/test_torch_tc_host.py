"""Host-side code of the tensor-core kernels B' and C', on the CPU (B''
and C'' in test_torch_tf32x3_host.py).

The kernels themselves run only on the card (tests/test_torch_cuda.py); what
surrounds them is Python and is checked here: the packing of the conv
weights into B''s K-major layout (against the JAX fused conv, on weights
carried over with ``torch_state_from_jax_params``), the shapes B' and C'
refuse, the 16-byte alignment check of every operand a TMA tensor map
names, the dispatch tables (dtype -> kernel -> launch counter), and the
ctypes signatures against the C entries of every kernel source.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from vae_tagger_tpu.ops.conv import effective_affine as jax_effective_affine
from vae_tagger_tpu.ops.conv import group_stats as jax_group_stats
from vae_tagger_tpu.ops.pallas.conv_fused import gn_silu_conv3x3_pallas
from vae_tagger_tpu_torch.io.checkpoints import torch_state_from_jax_params
from vae_tagger_tpu_torch.ops import _build, attention, backend, conv
from vae_tagger_tpu_torch.ops.normalization import group_norm_affine

GROUPS = 8


def _bf16_exact(rng, shape, scale=1.0):
    """Seeded values that bf16 represents exactly, as fp32 numpy."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


def _conv_from_packed(act, wpack, bias, res=None, scpack=None):
    """Kernel B''s product written out on the packed operands: for each of
    the 9 taps the shifted activated tile times that tap's (Cout, Cin)
    matrix, then the 1x1 shortcut as extra K steps on the residual."""
    n, h, w, _ = act.shape
    pad = F.pad(act, (0, 0, 1, 1, 1, 1))
    out = torch.zeros(n, h, w, wpack.shape[1])
    for t in range(9):
        dy, dx = divmod(t, 3)
        out += pad[:, dy:dy + h, dx:dx + w, :] @ wpack[t].float().t()
    if scpack is not None:
        out += res @ scpack.float().t()
    return out + bias


@pytest.mark.parametrize("variant", ["plain", "shortcut"])
def test_packed_weights_match_the_jax_fused_conv(variant):
    """HWIO weights of a JAX ResnetBlock tree -> torch state (OIHW) -> the
    port's HWIO view -> B''s packed (9, Cout, Cin) and (Cout, Cres) layouts;
    the product on the packed operands equals the Pallas fused conv."""
    rng = np.random.default_rng(11)
    c_in, c_out, hw = 40, 136 if variant == "shortcut" else 64, 6
    tree = {"conv1": {"kernel": _bf16_exact(rng, (3, 3, c_in, c_out), 0.05),
                      "bias": _bf16_exact(rng, (c_out,), 0.1)}}
    if variant == "shortcut":
        tree["conv_shortcut"] = {
            "kernel": _bf16_exact(rng, (1, 1, c_in, c_out), 0.1),
            "bias": _bf16_exact(rng, (c_out,), 0.1)}
    state = torch_state_from_jax_params(tree)
    hwio = state["conv1.weight"].permute(2, 3, 1, 0)  # the port's .hwio()
    wpack = conv.pack_conv3x3_weight(hwio)
    assert wpack.shape == (9, c_out, c_in) and wpack.dtype == torch.bfloat16
    assert wpack.is_contiguous()

    x = rng.normal(size=(2, hw, hw, c_in)).astype(np.float32)
    gs = (rng.normal(size=(c_in,)) * 0.2 + 1.0).astype(np.float32)
    gb = (rng.normal(size=(c_in,)) * 0.1).astype(np.float32)
    es, eb = group_norm_affine(torch.from_numpy(x), torch.from_numpy(gs),
                               torch.from_numpy(gb), num_groups=GROUPS)
    act = F.silu(torch.from_numpy(x) * es[:, None, None] + eb[:, None, None])
    res = scpack = scb = None
    if variant == "shortcut":
        res = torch.from_numpy(x)
        sc = state["conv_shortcut.weight"][:, :, 0, 0].t()  # (Cres, Cout)
        scpack = conv.pack_shortcut_weight(sc, c_in)
        assert scpack.shape == (c_out, c_in) and scpack.is_contiguous()
        scb = state["conv_shortcut.bias"]
    got = _conv_from_packed(act, wpack, state["conv1.bias"], res, scpack)
    if scb is not None:
        got = got + scb

    mean, meansq = jax_group_stats(jnp.asarray(x), GROUPS)
    jes, jeb = jax_effective_affine(mean, meansq, jnp.asarray(gs),
                                    jnp.asarray(gb), c_in, 1e-6)
    sc_tree = tree.get("conv_shortcut", {})
    with pltpu.force_tpu_interpret_mode():
        want = gn_silu_conv3x3_pallas(
            jnp.asarray(x), jes, jeb, jnp.asarray(tree["conv1"]["kernel"]),
            jnp.asarray(tree["conv1"]["bias"]),
            None if res is None else jnp.asarray(x),
            None if not sc_tree else jnp.asarray(sc_tree["kernel"]),
            None if not sc_tree else jnp.asarray(sc_tree["bias"]),
            tile_h=2, tile_cout=c_out, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape", [
    # (N, H, W, Cin, Cout, Cres): the encoder's 1024px convs, batch 4
    (4, 1024, 1024, 128, 128, 0),
    (4, 512, 512, 128, 256, 0),
    (4, 512, 512, 256, 256, 128),
    (4, 256, 256, 512, 512, 256),
    (4, 128, 128, 512, 512, 0),
    # ragged: H = 1, W below and past one 64-pixel tile, 40 -> 136 channels
    (1, 1, 11, 40, 136, 40),
    (2, 7, 130, 64, 96, 0),
])
def test_tc_conv_shape_accepts(shape):
    conv.check_tc_conv_shape(*shape)


@pytest.mark.parametrize("shape", [(1, 8, 8, 36, 64, 0),
                                   (1, 8, 8, 64, 100, 0),
                                   (1, 8, 8, 64, 64, 12),
                                   (0, 8, 8, 64, 64, 0)])
def test_tc_conv_shape_refuses(shape):
    with pytest.raises(ValueError):
        conv.check_tc_conv_shape(*shape)


def test_tma_alignment_check():
    base = torch.zeros(1024, dtype=torch.bfloat16)
    _build.check_tma_aligned(base, None, base[8:])  # 16-byte offsets pass
    for off in (1, 4):  # 2 and 8 bytes off
        with pytest.raises(ValueError, match="16-byte aligned"):
            _build.check_tma_aligned(base, base[off:])


@pytest.mark.parametrize("table,kernel_for,arg", [
    (attention.FWD_KERNELS, attention.fwd_kernel_for,
     lambda dt: torch.zeros(1, 4, 512, dtype=dt)),
    (conv.CONV_KERNELS, conv.conv_kernel_for,
     lambda dt: torch.zeros(1, 4, 4, 64, dtype=dt)),
])
def test_dispatch_tables(table, kernel_for, arg):
    """bf16 -> the tensor-core kernel, fp32 -> the 3xTF32 tensor-core
    kernel; each entry names a built library, its C function and its own
    launch counter."""
    assert set(table) == {torch.bfloat16, torch.float32}
    assert table[torch.bfloat16][0].endswith("_tc")
    assert table[torch.float32][0].endswith("_tf32x3")
    counters = set()
    for dt, (stem, fn, counter) in table.items():
        assert kernel_for(arg(dt)) == (stem, fn, counter)
        assert fn in _build.SIGNATURES[stem]
        assert counter in backend.LAUNCHES
        counters.add(counter)
    assert len(counters) == 2
    with pytest.raises(TypeError):
        kernel_for(arg(torch.float16))


def _c_params(kind):
    """ctypes type of one C parameter of a kernel entry."""
    if "*" in kind:
        return _build.ctypes.c_void_p
    if "long long" in kind:
        return _build.ctypes.c_longlong
    if kind.split()[0] == "float":
        return _build.ctypes.c_float
    assert kind.split()[0] == "int", kind
    return _build.ctypes.c_int


@pytest.mark.parametrize("stem", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entries(stem):
    """Every VT_EXPORT entry of csrc/<stem>.cu is in SIGNATURES with its
    parameters' ctypes types in order, and SIGNATURES names no other."""
    src = (_build._CSRC / f"{stem}.cu").read_text()
    entries = {name: [_c_params(p.strip()) for p in params.split(",")]
               for name, params in re.findall(
                   r"VT_EXPORT int (\w+)\(([^)]*)\)", src)}
    assert entries == _build.SIGNATURES[stem]


@pytest.mark.parametrize("d", [64, 128, 256, 1024])
def test_tc_attention_refuses_head_widths(d):
    # the forward's kernels C' (bf16) and C'' (fp32) take 512 alone
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head width"):
            attention.fwd_kernel_for(torch.zeros(1, 4, d, dtype=dt))
    # and so do the backward's, D'' and E'' (fp32) among them
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="head width"):
            attention.bwd_kernels_for(torch.zeros(1, 4, d, dtype=dt))
