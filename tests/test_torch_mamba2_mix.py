"""The Mamba2 prefill mixer's two kernels around the SSD scan
(``repro_torch.kernels.mamba2_mix``): their routing, their contract
checks, the mixer on the CPU bitwise as it was before the kernels (a
verbatim copy of that code below), and, marked ``cuda``, the kernels
against their plain version on the card.

Tolerances on the card: the bf16 ones of ``tests/test_torch_lm_kernels.py``
(2e-2 of the scale).  The kernels sum the conv and take SiLU and the gated
norm in float32 where the plain version rounds each step to bf16, so the
two differ by a few bf16 roundings of the conv's output and the gate.
"""

import dataclasses
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.mamba2_mix import ops, ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.partitioning import gathered
from repro_torch.models import blocks
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mamba2 import mamba2_mixer

ZYPHRA = "zamba2-2.7b-zyphra"
MAMBA2 = "mamba2-780m"
BF16_TOL = 2e-2


# ---------------------------------------------- the mixer before the kernels
def _conv_before(x, w, b):
    kw, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, kw - 1, 0))
    wd = w.to(x.dtype)
    y = 0
    for i in range(kw):  # the reference's summation order, in x's dtype
        y = y + xp[:, i:i + S, :] * wd[None, None, :, i]
    return y + b.to(x.dtype)[None, None, :]


def _mixer_before(p, cfg, u):
    """``models/mamba2.py::mamba2_mixer`` as it was before the kernels."""
    B_, S, _ = u.shape
    din, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    dtype = u.dtype

    zxbcdt = u @ gathered(p.in_proj, dtype)
    conv_dim = din + 2 * G * N
    z, xBC, dt_raw = (zxbcdt[..., :din], zxbcdt[..., din:din + conv_dim],
                      zxbcdt[..., din + conv_dim:])
    kw = p.conv_w.shape[1]
    conv_tail = xBC[:, -(kw - 1):, :].clone() if S >= kw - 1 else F.pad(
        xBC, (0, 0, kw - 1 - S, 0))
    xBC = F.silu(_conv_before(xBC, p.conv_w, p.conv_b))
    x = xBC[..., :din].reshape(B_, S, H, P)
    Bm = xBC[..., din:din + G * N].reshape(B_, S, G, N).contiguous()
    Cm = xBC[..., din + G * N:].reshape(B_, S, G, N).contiguous()

    dt = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B,S,H)
    A = -torch.exp(p.A_log.float())                       # (H,)

    X = (x.float() * dt[..., None]).to(dtype)
    Adt = (dt * A[None, None, :]).to(dtype)
    Y, final = ssd_ops.ssd(X, Adt, Bm, Cm, cfg.ssm_chunk)
    Y = Y + p.D.to(dtype)[None, None, :, None] * x
    y = Y.reshape(B_, S, din)
    y = rmsnorm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    return y @ gathered(p.out_proj, dtype), final, conv_tail


def _params(cfg, seed=0, device="cpu"):
    return ref.case(cfg, 1, 1, device=device, seed=seed)[0]


def _u(cfg, B, S, dtype, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, S, cfg.d_model), generator=g).to(device, dtype)


# ------------------------------------------------------------- on the CPU
@pytest.mark.parametrize("arch", [ZYPHRA, MAMBA2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [2, 37])
def test_the_mixer_on_the_cpu_is_bitwise_what_it_was(arch, dtype, S):
    """At the configuration's widths, S = 2 < KW - 1 (a padded conv tail)
    and S = 37: output, final state and conv tail bitwise, no launch."""
    cfg = get_config(arch)
    p = _params(cfg)
    u = _u(cfg, 2, S, dtype)
    ops.reset_launches()
    with torch.no_grad():
        got = mamba2_mixer(p, cfg, u)
        want = _mixer_before(p, cfg, u)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ops.LAUNCHES == {"mix_in": 0, "mix_out": 0}


def test_the_mixer_backward_on_the_cpu_is_what_it_was():
    """Autograd takes the plain version: every parameter's gradient and
    the input's bitwise as before, at a small width."""
    cfg = dataclasses.replace(get_config(ZYPHRA), d_model=32, ssm_state=8,
                              ssm_headdim=8, ssm_chunk=8)
    grads = []
    for fn in (mamba2_mixer, _mixer_before):
        p = _params(cfg, seed=4)
        for t in vars(p).values():
            t.requires_grad_(True)
        u = _u(cfg, 2, 19, torch.float32, seed=5).requires_grad_(True)
        out, final, _ = fn(p, cfg, u)
        (out.square().sum() + final.sum()).backward()
        grads.append([u.grad] + [t.grad for t in vars(p).values()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _mix_args(cfg, B, S, dtype, device="cpu", seed=2):
    p, zx, _ = ref.case(cfg, B, S, dtype, device, seed)
    return p, zx


def _recorder(monkeypatch, on_card=lambda t: True):
    """Stub the card: ``_on_card`` as given (true for every tensor), the
    library loaded as nothing and each launch recorded by its entry
    point."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", on_card)
    monkeypatch.setattr(ops.build, "load", lambda source, sigs: None)
    monkeypatch.setattr(ops.build, "launch",
                        lambda lib, fn, dev, *args: calls.append(fn))
    return calls


def _scan(X, Adt, Bm, Cm):
    """A stand-in for the SSD scan with its outputs' shapes, reading every
    input (so each has a gradient)."""
    B, S, H, P = X.shape
    Y = X * torch.exp(Adt)[..., None] + (Bm * Cm).sum((-1, -2))[
        ..., None, None]
    final = X.float().sum(1)[..., None].expand(B, H, P, Bm.shape[3])
    return Y, final.contiguous()


def _run_mixer(p, zx, cfg):
    return ops.mixer(zx, p, cfg, _scan)


SMALL = dict(d_model=64, ssm_state=16, ssm_headdim=16)


@pytest.mark.parametrize("case", ["no_grad", "grad_mode_nothing_requires",
                                  "float32", "input_requires_grad",
                                  "param_requires_grad", "real_cpu",
                                  "real_cpu_requires_grad"])
def test_routing(monkeypatch, case):
    """The route follows the device alone: on the card (stubbed) every call
    takes the kernels, float32 its float32 instance and a call autograd
    records the kernels inside their autograd functions; a CPU tensor
    takes the plain version, whatever its dtype and grad."""
    cfg = dataclasses.replace(get_config(ZYPHRA), **SMALL)
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    p, zx = _mix_args(cfg, 2, 9, dtype)
    calls = [] if case.startswith("real_cpu") else _recorder(monkeypatch)
    if case in ("input_requires_grad", "real_cpu_requires_grad"):
        zx.requires_grad_(True)
    if case == "param_requires_grad":
        p.conv_w.requires_grad_(True)
    ops.reset_launches()
    ctx = torch.no_grad() if case == "no_grad" else torch.enable_grad()
    with ctx:
        y, final = _run_mixer(p, zx, cfg)
    assert y.shape == (2, 9, cfg.d_inner) and y.dtype == dtype
    kernels = not case.startswith("real_cpu")
    recorded = case.endswith("requires_grad")
    assert y.requires_grad == recorded
    n = int(kernels)
    suffix = "f32" if dtype == torch.float32 else "bf16"
    assert calls == [f"ksp_mamba2_mix_in_{suffix}",
                     f"ksp_mamba2_mix_out_{suffix}"] * n
    assert ops.LAUNCHES == {"mix_in": n, "mix_out": n}
    if not kernels:
        assert torch.equal(y, _plain_mixer(p, zx, cfg)[0])


def _mesh_case(cfg, requires_grad):
    p, zx = _mix_args(cfg, 2, 9, torch.float32)
    if requires_grad:
        for t in [zx] + list(vars(p).values()):
            t.requires_grad_(True)
    return p, zx


def _distribute(p, zx, mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dist = types.SimpleNamespace(**{
        k: distribute_tensor(v.detach(), mesh, [Replicate()]).requires_grad_(
            v.requires_grad) for k, v in vars(p).items()})
    dzx = distribute_tensor(zx.detach(), mesh, [Shard(0)]).requires_grad_(
        zx.requires_grad)
    return dist, dzx


def _plain_mixer(p, zx, cfg):
    return ref.mixer(zx, p, cfg, _scan)


def test_a_dtensor_takes_the_plain_version(monkeypatch):
    """A CPU mesh's DTensors (one rank) go to the plain version: no launch,
    the plain version's result."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import process_world
    cfg = dataclasses.replace(get_config(ZYPHRA), **SMALL)
    p, zx = _mix_args(cfg, 2, 9, torch.bfloat16)
    calls = _recorder(monkeypatch, on_card=lambda t: t.device.type == "cuda")
    ops.reset_launches()
    with process_world("cpu"):
        mesh = init_device_mesh("cpu", (1,))
        dist, dzx = _distribute(p, zx, mesh)
        with torch.no_grad():
            y, _ = _run_mixer(dist, dzx, cfg)
        got = y.full_tensor()
    assert calls == [] and ops.LAUNCHES == {"mix_in": 0, "mix_out": 0}
    assert torch.equal(got, _plain_mixer(p, zx, cfg)[0])


@pytest.mark.parametrize("requires_grad", [False, True])
def test_a_card_mesh_runs_each_batch_shard(monkeypatch, requires_grad):
    """A card's mesh (stubbed: the DTensors say "card", their local shards
    take the plain version) runs the mixer on each device's batch rows:
    output, final state and every gradient as the plain version's on whole
    tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.device import process_world
    cfg = dataclasses.replace(get_config(ZYPHRA), **SMALL)
    _recorder(monkeypatch, on_card=lambda t: isinstance(t, DTensor))
    p, zx = _mesh_case(cfg, requires_grad)
    want_y, want_final = _plain_mixer(p, zx, cfg)
    with process_world("cpu"):
        mesh = init_device_mesh("cpu", (1,))
        dist, dzx = _distribute(p, zx, mesh)
        y, final = _run_mixer(dist, dzx, cfg)
        assert y.placements == dzx.placements
        assert torch.equal(y.full_tensor(), want_y)
        assert torch.equal(final.full_tensor(), want_final)
        if requires_grad:
            dy = torch.randn(want_y.shape, generator=torch.Generator()
                             .manual_seed(3))
            (want_y * dy).sum().backward()
            (y * _distribute_like(dy, y)).sum().backward()
            for name in ops._PARAMS:
                torch.testing.assert_close(
                    getattr(dist, name).grad.full_tensor(),
                    getattr(p, name).grad, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(dzx.grad.full_tensor(), zx.grad,
                                       rtol=1e-6, atol=1e-6)


def _distribute_like(t, like):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, like.device_mesh, like.placements)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_backward_is_the_plain_backward(monkeypatch, dtype):
    """On the card's route under autograd (the card stubbed, each launch
    stood in for by the plain version), the gradients of every input are
    the plain version's: the backward recomputes it on the saved inputs
    (within 1e-5 of the scale in float32; in bf16 within the bf16 rule, as
    x's two uses add their gradients in another order)."""
    cfg = dataclasses.replace(get_config(ZYPHRA), **SMALL)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_launch_in", lambda *a: ref.mix_in(*a)[:4])
    monkeypatch.setattr(ops, "_launch_out", lambda Y, zx, w, b, D, s, eps:
                        ref.mix_out(Y, zx, ref.conv_x(zx, w, b, D.shape[0]),
                                    D, s, eps))
    grads = []
    for route in (_run_mixer, _plain_mixer):
        p, zx = _mesh_case(cfg, True)
        zx = zx.detach().to(dtype).requires_grad_(True)
        y, final = route(p, zx, cfg)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
        (y.float() * dy).sum().backward()
        grads.append([zx.grad] + [t.grad for t in vars(p).values()])
    for (name, a), b in zip([("zx", None)] + list(vars(p).items()),
                            zip(*grads)):
        got, want = b
        if want is None:
            assert got is None, name
            continue
        tol = 1e-5 if dtype == torch.float32 else BF16_TOL
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * scale, msg=name)


def test_a_dry_run_takes_the_operators(monkeypatch):
    """Inside a dry run (fake tensors on the CPU) the mixer calls the mix
    kernels' operators, as the card does, never the plain forward; no
    launch is counted, and the dry run counts each operator's bytes by
    ``io_bytes``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import dryrun as kernel_dryrun
    from repro_torch.launch import dryrun

    def refuse(*a, **kw):
        raise AssertionError("a dry run reached the plain mixer")
    monkeypatch.setattr(ref, "mixer", refuse)
    cfg = dataclasses.replace(get_config(ZYPHRA), **SMALL)
    p, zx = _mix_args(cfg, 2, 9, torch.bfloat16)
    seen = []
    orig = dryrun._kernel_io

    def io(func, args):
        got = orig(func, args)
        if "mamba2_mix" in str(func):
            seen.append(got)
        return got
    monkeypatch.setattr(dryrun, "_kernel_io", io)
    ops.reset_launches()
    with FakeTensorMode() as mode, kernel_dryrun.dry_run():
        fp = types.SimpleNamespace(**{k: mode.from_tensor(v)
                                      for k, v in vars(p).items()})
        counter = dryrun.DeviceCounter()
        with counter:
            y, final = _run_mixer(fp, mode.from_tensor(zx), cfg)
    assert y.shape == (2, 9, cfg.d_inner) and y.dtype == torch.bfloat16
    assert ops.LAUNCHES == {"mix_in": 0, "mix_out": 0}
    args = (2, 9, cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state)
    assert seen == [ops.io_bytes(*args, "mix_in"),
                    ops.io_bytes(*args[:4], 1, 1, "mix_out")]


def _bad(kind):
    """``(zxbcdt, conv_w, d_inner, heads, groups, state, Y)`` that the
    kernels refuse for ``kind``."""
    din, H, G, N = 64, 4, 1, 16
    Z, C = 2 * din + 2 * G * N + H, din + 2 * G * N
    zx = torch.zeros((2, 5, Z), dtype=torch.bfloat16)
    w = torch.zeros((C, 4))
    Y = torch.zeros((2, 5, H, din // H), dtype=torch.bfloat16)
    if kind == "conv_width":
        w = torch.zeros((C, 3))
    elif kind == "dtype":
        zx, Y = zx.half(), Y.half()
    elif kind == "y_dtype":
        Y = Y.float()
    elif kind == "misaligned":
        zx = torch.zeros(2 * 5 * Z + 1, dtype=torch.bfloat16)[1:].view(
            2, 5, Z)
    elif kind == "strided":
        zx = torch.zeros((5, 2, Z), dtype=torch.bfloat16).transpose(0, 1)
    elif kind == "width_off_8":    # d_inner 60: 4 heads of 15
        din, H = 60, 4
        Z, C = 2 * din + 2 * G * N + H, din + 2 * G * N
        zx = torch.zeros((2, 5, Z), dtype=torch.bfloat16)
        w = torch.zeros((C, 4))
        Y = torch.zeros((2, 5, H, din // H), dtype=torch.bfloat16)
    elif kind == "zx_width":
        zx = torch.zeros((2, 5, Z + 8), dtype=torch.bfloat16)
    elif kind == "y_shape":
        Y = torch.zeros((2, 5, H, din // H + 8), dtype=torch.bfloat16)
    elif kind in ("too_wide", "too_wide_f32"):
        f32 = kind == "too_wide_f32"
        din = (ops.MAX_D_INNER_F32 if f32 else ops.MAX_D_INNER) + 64
        H = din // 64
        Z, C = 2 * din + 2 * G * N + H, din + 2 * G * N
        zx = torch.zeros((1, 1, Z),
                         dtype=torch.float32 if f32 else torch.bfloat16)
        w = torch.zeros((C, 4))
        Y = None
    elif kind == "strided_f32":
        zx = torch.zeros((5, 2, Z)).transpose(0, 1)
        Y = Y.float()
    return zx, w, din, H, G, N, Y


@pytest.mark.parametrize("kind,error", [
    ("conv_width", ValueError), ("dtype", TypeError), ("y_dtype", TypeError),
    ("misaligned", ValueError), ("strided", ValueError),
    ("width_off_8", ValueError), ("zx_width", ValueError),
    ("y_shape", ValueError), ("too_wide", ValueError),
    ("too_wide_f32", ValueError), ("strided_f32", ValueError)])
def test_the_contract_checks_raise(kind, error):
    zx, w, din, H, G, N, Y = _bad(kind)
    with pytest.raises(error):
        ops.check(zx, w, din, H, G, N, Y=Y)


def test_float32_takes_widths_off_8_and_any_alignment():
    """The float32 instance reads elements, not 16-byte vectors: d_inner
    60 (4 heads of 15) and rows off 16 bytes pass its checks."""
    din, H, G, N = 60, 4, 1, 6
    Z, C = 2 * din + 2 * G * N + H, din + 2 * G * N
    zx = torch.zeros(2 * 5 * Z + 1)[1:].view(2, 5, Z)
    Y = torch.zeros((2, 5, H, din // H))
    assert ops.check(zx, torch.zeros((C, 4)), din, H, G, N, Y=Y) == (
        2, 5, Z, din // H, G * N)


@pytest.mark.parametrize("arch", [ZYPHRA, MAMBA2])
def test_the_configurations_meet_the_contract(arch):
    cfg = get_config(arch)
    din, H, G, N = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups,
                    cfg.ssm_state)
    Z = 2 * din + 2 * G * N + H
    zx = torch.zeros((1, 2, Z), dtype=torch.bfloat16)
    w = torch.zeros((din + 2 * G * N, blocks.CONV_KW))
    Y = torch.zeros((1, 2, H, din // H), dtype=torch.bfloat16)
    assert ops.check(zx, w, din, H, G, N, Y=Y) == (1, 2, Z, din // H, G * N)


def test_the_conv_width_and_the_kernel_names():
    """The kernels' conv width (``m2mix::kKW``) is the models'; the device
    kernels live in ``m2mix::``, apart from the names the scan's roofline
    reads."""
    src = Path(ops.SOURCE).read_text()
    assert f"constexpr int kKW = {blocks.CONV_KW};" in src
    assert "namespace m2mix" in src
    for name in ("ssd3::", "ssd_fwd", "flash_fwd"):
        assert name not in src
    assert f"kMaxDinF32 = {ops.MAX_D_INNER_F32};" in src


def test_io_bytes_at_the_cell_shape():
    """8 x 3840 at Zyphra's widths: 654.7 MB in and out of mix_in, 1.258
    GB of mix_out."""
    cfg = get_config(ZYPHRA)
    args = (8, 3840, cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups,
            cfg.ssm_state)
    assert ops.io_bytes(*args, "mix_in") == 2 * 30720 * (5248 + 80 + 5120
                                                         + 80 + 128)
    assert ops.io_bytes(*args, "mix_out") == 2 * 30720 * 4 * 5120


# ------------------------------------------------------------- on the card
def _nearer(got, plain, exact, what):
    """The kernel at least as near the float32 computation on the same
    operands as the plain bf16 route (the kernel rounds once where the
    plain route rounds each step)."""
    e_k = float((got.float() - exact).abs().max())
    e_p = float((plain.float() - exact).abs().max())
    assert e_k <= e_p, f"{what}: kernel {e_k:.3g}, plain {e_p:.3g} from f32"


@pytest.mark.cuda
class TestMixOnCard:
    """``mix_in``, ``mix_out`` and the whole mixer against the plain
    version on the same CUDA tensors."""

    @staticmethod
    def _need_card():
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")

    @staticmethod
    def _close(got, want, tol=BF16_TOL):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=tol * scale)

    @pytest.mark.parametrize("arch,S", [(ZYPHRA, 3), (ZYPHRA, 257),
                                        (ZYPHRA, 1024), (ZYPHRA, 1000),
                                        (MAMBA2, 257), (MAMBA2, 1000)])
    def test_mix_in_and_out(self, arch, S):
        """bf16: within 2e-2 of the scale of the plain route, at least as
        near the float32 computation on the same operands (weights, bias
        and D rounded to bf16 as both routes take them), two calls
        bitwise equal."""
        self._need_card()
        cfg = get_config(arch)
        din, H, G, N = (cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups,
                        cfg.ssm_state)
        p, zx, Y = ref.case(cfg, 2, S, torch.bfloat16, "cuda", seed=S)
        args_in = (zx, p.conv_w, p.conv_b, p.dt_bias, p.A_log, din, G, N)
        args_out = (Y, zx, p.conv_w, p.conv_b, p.D, p.norm_scale,
                    cfg.norm_eps)
        r = {k: getattr(p, k).to(zx.dtype).float()
             for k in ("conv_w", "conv_b", "D")}
        with torch.no_grad():
            before = dict(ops.LAUNCHES)
            got = ops.mix_in(*args_in)
            again = ops.mix_in(*args_in)
            want = ref.mix_in(*args_in)
            exact = ref.mix_in(zx.float(), r["conv_w"], r["conv_b"],
                               *args_in[3:])
            for name, a, a2, b, e in zip(("X", "Adt", "Bm", "Cm"), got,
                                         again, want, exact):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert a.is_contiguous() and torch.equal(a, a2)
                self._close(a, b)
                if name != "Adt":
                    _nearer(a, b, e, name)
            y = ops.mix_out(*args_out)
            y2 = ops.mix_out(*args_out)
            y_want = ref.mix_out(Y, zx, want[4], p.D, p.norm_scale,
                                 cfg.norm_eps)
            y_exact = ref.mix_out(Y.float(), zx.float(),
                                  exact[4].to(zx.dtype).float(), r["D"],
                                  p.norm_scale, cfg.norm_eps)
        assert torch.equal(y, y2)
        self._close(y, y_want)
        _nearer(y, y_want, y_exact, "y")
        assert ops.LAUNCHES == {"mix_in": before["mix_in"] + 2,
                                "mix_out": before["mix_out"] + 2}

    @pytest.mark.parametrize("arch,S", [(ZYPHRA, 3), (ZYPHRA, 300),
                                        (MAMBA2, 257)])
    def test_float32_instance(self, arch, S):
        """float32: the plain route's operations in its order, within 1e-5
        of the scale, two calls bitwise equal."""
        self._need_card()
        cfg = get_config(arch)
        din, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        p, zx, Y = ref.case(cfg, 2, S, torch.float32, "cuda", seed=S)
        args_in = (zx, p.conv_w, p.conv_b, p.dt_bias, p.A_log, din, G, N)
        args_out = (Y, zx, p.conv_w, p.conv_b, p.D, p.norm_scale,
                    cfg.norm_eps)
        with torch.no_grad():
            got, again = ops.mix_in(*args_in), ops.mix_in(*args_in)
            want = ref.mix_in(*args_in)
            for a, a2, b in zip(got, again, want):
                assert a.dtype == torch.float32 and torch.equal(a, a2)
                self._close(a, b, 1e-5)
            y, y2 = ops.mix_out(*args_out), ops.mix_out(*args_out)
            y_want = ref.mix_out(Y, zx, want[4], p.D, p.norm_scale,
                                 cfg.norm_eps)
        assert torch.equal(y, y2)
        self._close(y, y_want, 1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_the_backward(self, dtype):
        """Under autograd the kernels launch and every gradient is the
        plain route's (recomputed on the same inputs) within 1e-4 of its
        scale in float32, 2e-2 in bf16; the outputs as the forward's."""
        self._need_card()
        cfg = get_config(ZYPHRA)
        grads, outs = [], []
        for route in (ops.mixer, ref.mixer):
            p, zx, _ = ref.case(cfg, 2, 300, dtype, "cuda", seed=11)
            for t in [zx] + list(vars(p).values()):
                t.requires_grad_(True)
            before = dict(ops.LAUNCHES)
            y, final = route(zx, p, cfg, lambda *a: ssd_ops.ssd(
                *a, cfg.ssm_chunk))
            dy = torch.randn(y.shape, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(2))
            (y.float() * dy).sum().backward()
            n = int(route is ops.mixer)
            assert {k: v - before[k] for k, v in ops.LAUNCHES.items()} == {
                "mix_in": n, "mix_out": n}
            outs.append(y.detach())
            grads.append([zx.grad] + [p.in_proj.grad is None]
                         + [t.grad for k, t in vars(p).items()
                            if k not in ("in_proj", "out_proj")])
        tol = 1e-4 if dtype == torch.float32 else BF16_TOL
        self._close(outs[0], outs[1], tol)
        for a, b in zip(*grads):
            if isinstance(a, bool):
                assert a and b
                continue
            self._close(a, b, tol)

    @pytest.mark.parametrize("arch,S", [(ZYPHRA, 2), (ZYPHRA, 3),
                                        (ZYPHRA, 1000), (MAMBA2, 513)])
    def test_the_mixer(self, arch, S):
        self._need_card()
        cfg = get_config(arch)
        p = _params(cfg, seed=S, device="cuda")
        u = _u(cfg, 2, S, torch.bfloat16, seed=S + 1, device="cuda")
        with torch.no_grad():
            out, final, tail = mamba2_mixer(p, cfg, u)
            out2, final2, tail2 = mamba2_mixer(p, cfg, u)
            w_out, w_final, w_tail = _mixer_before(p, cfg, u)
        assert torch.equal(out, out2) and torch.equal(final, final2)
        assert torch.equal(tail, w_tail) and torch.equal(tail2, w_tail)
        self._close(out, w_out)
        self._close(final, w_final)

    def test_a_card_mesh(self):
        """DTensors on the card's one-rank mesh take the kernels on the
        local batch rows: one launch each, the plain route's result."""
        self._need_card()
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.device import process_world
        cfg = get_config(ZYPHRA)
        p, zx, _ = ref.case(cfg, 2, 300, torch.bfloat16, "cuda", seed=5)
        scan = lambda *a: ssd_ops.ssd(*a, cfg.ssm_chunk)  # noqa: E731
        with torch.no_grad():
            want, _ = ref.mixer(zx, p, cfg, scan)
            with process_world("cuda"):
                mesh = init_device_mesh("cuda", (1,))
                dist, dzx = _distribute(p, zx, mesh)
                before = dict(ops.LAUNCHES)
                y, _ = ops.mixer(dzx, dist, cfg, scan)
                got = y.full_tensor()
        assert {k: v - before[k] for k, v in ops.LAUNCHES.items()} == {
            "mix_in": 1, "mix_out": 1}
        self._close(got, want)
