"""The one-pass NAdam step (``training/optim.py``) and its sm_90a kernel K4
(``csrc/nadam_step.cu``).

On the CPU a step runs the plain chain (``optim.nadam_plain``): it is held
bit for bit against the loop it was moved out of (copied below as it
was), K4's launch counter stays 0, and the kernel's argument checks
(``optim.kernel_pair``, ``optim.grad_layout``) raise where they should.
The plain chain is held against optax by ``tests/test_torch_training.py``.

On a card (tests marked ``cuda``, skipped without one) K4's parameters
and moments after 3 steps must equal the plain chain's on the same card
bit for bit, and ``LAUNCHES`` must advance by the launches expected: the
stacked tensor lists of the benchmark's three NAdam cells (SynthesisFull
x 4 seeds with every tensor decayed, CNN-RNN x 4 with the per-seed mask,
CNN-RNN x 1), float32 with float32 or bfloat16 moments and float64;
ragged sizes and storage that is not 16-byte aligned; gradients that are
not contiguous (channels-last convolution weights, as cuDNN hands them);
a ``SeedNAdam.select`` between steps; optimizers that take more than one
launch. What K4 does not take raises.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_nadam_kernel.py
"""

import pytest
import torch

from decode_tonal_langauge_tpu_torch.training import optim
from decode_tonal_langauge_tpu_torch.training.optim import NAdam, SeedNAdam


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _replaced_step(opt, grads):
    """``NAdam.step``'s loop as it was before the kernel, on ``opt``'s
    tensors (its count already advanced)."""
    b1, b2 = opt.b1, opt.b2
    bc1 = optim._bias_correction(b1, opt.count)
    bc1_next = optim._bias_correction(b1, opt.count + 1)
    bc2 = optim._bias_correction(b2, opt.count)
    for p, g, mu, nu, decays in zip(opt.params, grads, opt.mu, opt.nu, opt.decay):
        dtype = torch.promote_types(p.dtype, torch.float32)
        g = g.to(dtype)
        if opt.weight_decay and decays:
            g = g + opt.weight_decay * p
        m = (1 - b1) * g + b1 * mu.to(dtype)
        v = (1 - b2) * (g * g) + b2 * nu.to(dtype)
        mu_hat = b1 * (m / bc1_next) + (1 - b1) * (g / bc1)
        update = mu_hat / (torch.sqrt(v / bc2) + opt.eps)
        p.copy_(p + update * -opt.learning_rate)
        mu.copy_(m)
        nu.copy_(v)


def _plain_step(opt, grads):
    """One step of ``opt`` through the plain chain, on any device."""
    opt.count += 1
    optim.nadam_plain(opt.params, grads, opt.mu, opt.nu, opt.decay, opt.hyper())


def _draw(gen, shape, dtype):
    """Seeded normal values on the CPU, drawn in float64 and rounded."""
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)


def _pair(shapes, dtype, device, kind=NAdam, seed=0, **kw):
    """Two optimizers over equal seeded tensors: one to step through
    ``step``, one through the plain chain."""
    gen = torch.Generator().manual_seed(seed)
    params = [_draw(gen, s, dtype) for s in shapes]
    return tuple(kind([p.clone().to(device) for p in params], **kw) for _ in range(2))


def _assert_equal(a, b):
    for x, y in zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- CPU ---------------------------------------------------------------------

_SMALL = [(3, 4), (4,), (2, 3, 5, 1), (7,), (1,)]


@pytest.mark.parametrize("dtype,moment_dtype,wd,decay_all", [
    (torch.float32, None, 0.0, False), (torch.float32, None, 0.01, False),
    (torch.float32, None, 0.004, True), (torch.float32, "bfloat16", 0.01, False),
    (torch.float64, None, 0.01, False),
])
def test_cpu_step_is_the_replaced_loop(dtype, moment_dtype, wd, decay_all):
    launches = optim.LAUNCHES
    opt, ref = _pair(_SMALL, dtype, "cpu", seed=1, learning_rate=1e-2, weight_decay=wd,
                     moment_dtype=moment_dtype, decay_all=decay_all)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        grads = [_draw(gen, p.shape, dtype) for p in opt.params]
        opt.step(grads)
        ref.count += 1
        _replaced_step(ref, grads)
    _assert_equal(opt, ref)
    assert opt.count == 3 and optim.LAUNCHES == launches


def test_cpu_seed_nadam_select_is_the_replaced_loop():
    shapes = [(4, 3, 4), (4, 4), (4, 2, 5)]
    opt, ref = _pair(shapes, torch.float32, "cpu", SeedNAdam, seed=3, learning_rate=1e-3,
                     weight_decay=0.01)
    assert opt.decay == [True, False, True]
    gen = torch.Generator().manual_seed(4)
    for step in range(3):
        if step == 1:
            keep = torch.tensor([0, 2, 3])
            for o in (opt, ref):
                o.select([p[keep] for p in o.params], keep)
        grads = [_draw(gen, p.shape, torch.float32) for p in opt.params]
        opt.step(grads)
        ref.count += 1
        _replaced_step(ref, grads)
    _assert_equal(opt, ref)


def test_cpu_step_takes_each_parameters_grad():
    opt, ref = _pair(_SMALL, torch.float32, "cpu", seed=5, learning_rate=1e-2,
                     weight_decay=0.01)
    gen = torch.Generator().manual_seed(6)
    for p, q in zip(opt.params, ref.params):
        p.grad = _draw(gen, p.shape, torch.float32)
        q.grad = p.grad.clone()
    opt.step()
    _plain_step(ref, [q.grad for q in ref.params])
    _assert_equal(opt, ref)


def _tensors(dtype=torch.float32, moment=None, n=3):
    params = [torch.zeros(2, 3, dtype=dtype) for _ in range(n)]
    grads = [torch.zeros(2, 3, dtype=dtype) for _ in range(n)]
    mu = [torch.zeros(2, 3, dtype=moment or dtype) for _ in range(n)]
    nu = [torch.zeros(2, 3, dtype=moment or dtype) for _ in range(n)]
    return params, grads, mu, nu


@pytest.mark.parametrize("dtype,moment,code", [
    (torch.float32, None, 0), (torch.float32, torch.bfloat16, 1), (torch.float64, None, 2),
])
def test_kernel_pair_codes(dtype, moment, code):
    assert optim.kernel_pair(*_tensors(dtype, moment)) == code


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", [
    "float32_float64", "float64_bfloat16", "float64_float32", "bfloat16_bfloat16",
    "float16_float16", "grad_dtype", "mixed_moments", "grad_device", "moment_device",
    "grad_shape", "moment_shape", "param_strided", "moment_strided", "grad_six_dims",
    "lengths", "empty",
])
def test_kernel_pair_raises(case):
    pairs = {"float32_float64": (torch.float32, torch.float64),
             "float64_bfloat16": (torch.float64, torch.bfloat16),
             "float64_float32": (torch.float64, torch.float32),
             "bfloat16_bfloat16": (torch.bfloat16, None),
             "float16_float16": (torch.float16, None)}
    params, grads, mu, nu = _tensors(*pairs.get(case, (torch.float32, None)))
    if case == "grad_dtype":
        grads[1] = grads[1].double()
    elif case == "mixed_moments":
        nu[2] = nu[2].to(torch.bfloat16)
    elif case == "grad_device":
        grads[1] = grads[1].to("meta")
    elif case == "moment_device":
        mu[0] = mu[0].to("meta")
    elif case == "grad_shape":
        grads[2] = torch.zeros(3, 2)
    elif case == "moment_shape":
        nu[1] = torch.zeros(6)
    elif case == "param_strided":
        params[0] = torch.zeros(3, 2).t()
    elif case == "moment_strided":
        mu[1] = torch.zeros(3, 2).t()
    elif case == "grad_six_dims":  # no two neighbouring dims step as one
        params[0] = torch.zeros((2,) * 6)
        grads[0] = torch.zeros((2,) * 6).permute(5, 4, 3, 2, 1, 0)
        mu[0], nu[0] = torch.zeros_like(params[0]), torch.zeros_like(params[0])
    elif case == "lengths":
        nu = nu[:2]
    elif case == "empty":
        params, grads, mu, nu = [], [], [], []
    with pytest.raises((TypeError, ValueError)):
        optim.kernel_pair(params, grads, mu, nu)


def test_kernel_pair_takes_strided_gradients():
    params, grads, mu, nu = _tensors()
    params[0], mu[0], nu[0] = (torch.zeros(8, 4, 7, 1) for _ in range(3))
    grads[0] = _channels_last(torch.zeros(8, 4, 7, 1))
    grads[1] = torch.zeros(3, 2).t()
    grads[2] = torch.zeros(1, 3).expand(2, 3)
    assert optim.kernel_pair(params, grads, mu, nu) == 0


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(4, 5), None),
    (lambda: torch.as_strided(torch.zeros(20), (4, 1, 5), (5, 7, 1)), None),
    (lambda: torch.zeros(5, 4).t(), [(4, 1), (5, 4)]),
    (lambda: _channels_last(torch.zeros(8, 4, 7, 1)), [(8, 28), (4, 1), (7, 4)]),
    (lambda: _channels_last(torch.zeros(8, 4, 7, 3)), [(8, 84), (4, 1), (21, 4)]),
    (lambda: torch.zeros(1, 3).expand(2, 3), [(2, 0), (3, 1)]),
    (lambda: torch.zeros(4, 6)[:, ::2], [(12, 2)]),
    (lambda: _channels_last(torch.zeros(32, 4, 7, 1)).view(4, 8, 4, 7, 1),
     [(32, 28), (4, 1), (7, 4)]),
])
def test_grad_layout_collapses(make, want):
    g = make()
    got = optim.grad_layout(g)
    assert got == want
    if got is not None:  # the kernel's offsets of the elements in row-major order
        rest, off = torch.arange(g.numel()), torch.zeros(g.numel(), dtype=torch.long)
        for size, stride in reversed(got):
            off += rest % size * stride
            rest //= size
        storage = torch.arange(g.untyped_storage().nbytes() // g.element_size())
        base = g.storage_offset()
        assert torch.equal(off + base, storage.as_strided(g.shape, g.stride(), base).reshape(-1))


def test_cuda_step_refuses_cpu_tensors():
    launches = optim.LAUNCHES
    params, grads, mu, nu = _tensors()
    with pytest.raises(ValueError):
        optim.nadam_cuda(params, grads, mu, nu, [True] * 3,
                         optim.Hyper(1e-3, 0.0, 0.9, 0.999, 1e-8, 0.1, 0.19, 0.001))
    assert optim.LAUNCHES == launches


# -- the card ----------------------------------------------------------------

def _cell_shapes(cell):
    """The stacked parameter shapes, optimizer kind and options of a
    benchmark cell's fit (models built on the meta device)."""
    from decode_tonal_langauge_tpu_torch.models.factory import (build_synthesis_model,
                                                                get_classifier_by_name)

    with torch.device("meta"):
        if cell == "synthfull_fit.s4_b8":
            model = build_synthesis_model("SynthesisFull", 2560, 40, 200, dtype="float32")
        else:
            model = get_classifier_by_name("CNNRNN", 4, 6, 200,
                                           classifier_kwargs={"lstm_dim": 800})
    shapes = [tuple(p.shape) for p in model.parameters()]
    if cell == "synthfull_fit.s4_b8":
        return [(4,) + s for s in shapes], SeedNAdam, dict(
            learning_rate=5e-4, weight_decay=0.004, decay_all=True)
    if cell == "cnnrnn_fit.s4_b32":
        return [(4,) + s for s in shapes], SeedNAdam, dict(learning_rate=5e-4,
                                                           weight_decay=0.01)
    return shapes, NAdam, dict(learning_rate=5e-4, weight_decay=0.01)


def _run_both(opt, ref, steps=3, seed=7, grad=None, select=None):
    """``steps`` steps of both optimizers on equal seeded gradients (made
    on the card; ``grad`` may change each one's layout); ``select``: keep
    these seeds before the second step. Returns K4's launches."""
    gen = torch.Generator(device=opt.params[0].device).manual_seed(seed)
    launches = optim.LAUNCHES
    for step in range(steps):
        if select is not None and step == 1:
            keep = torch.tensor(select, device=opt.params[0].device)
            for o in (opt, ref):
                o.select([p[keep] for p in o.params], keep)
        grads = [torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype)
                 for p in opt.params]
        if grad is not None:
            grads = [grad(g) for g in grads]
        opt.step(grads)
        _plain_step(ref, grads)
    torch.cuda.synchronize()
    return optim.LAUNCHES - launches


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["synthfull_fit.s4_b8", "cnnrnn_fit.s4_b32",
                                  "cnnrnn_fit.s1_b16"])
def test_cell_lists_match_plain(card, cell):
    shapes, kind, kw = _cell_shapes(cell)
    opt, ref = _pair(shapes, torch.float32, card, kind, seed=11, **kw)
    assert _run_both(opt, ref) == 3
    _assert_equal(opt, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype,dtype", [("bfloat16", torch.float32),
                                                (None, torch.float64)])
def test_dtype_pairs_match_plain(card, moment_dtype, dtype):
    shapes, _, kw = _cell_shapes("cnnrnn_fit.s1_b16")
    opt, ref = _pair(shapes, dtype, card, seed=12, moment_dtype=moment_dtype, **kw)
    assert _run_both(opt, ref) == 3
    _assert_equal(opt, ref)


_RAGGED = [(1,), (3,), (5, 7), (17,), (65537,), (3, 43691), (131071,), (4, 65536)]


def _offset(t, by):
    """``t``'s values in storage that starts ``by`` elements into a buffer."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    out = buf[by:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,moment_dtype", [(torch.float32, None),
                                                (torch.float32, "bfloat16"),
                                                (torch.float64, None)])
@pytest.mark.parametrize("where", ["aligned", "params", "grads", "moments"])
def test_ragged_and_unaligned_match_plain(card, dtype, moment_dtype, where):
    opt, ref = _pair(_RAGGED, dtype, card, seed=13, learning_rate=1e-3, weight_decay=0.01,
                     moment_dtype=moment_dtype)
    for o in (opt, ref):
        if where == "params":
            o.params = [_offset(p, 1) for p in o.params]
        if where == "moments":
            o.mu = [_offset(m, 1) for m in o.mu]
            o.nu = [_offset(v, 3) for v in o.nu]
    grad = (lambda g: _offset(g, 1)) if where == "grads" else None
    assert _run_both(opt, ref, grad=grad) == 3
    _assert_equal(opt, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_strided_grads_match_plain(card, dtype):
    shapes = [(512, 1024, 7, 1), (256, 512, 7, 1), (4, 256, 512, 7, 1), (33, 5, 3, 2),
              (7, 9), (2, 4, 6)]

    def grad(g):
        if g.ndim == 4:
            return _channels_last(g)
        if g.ndim == 5:  # a seed stack of channels-last weights
            return _channels_last(g.reshape(-1, *g.shape[2:])).view(g.shape)
        return g.transpose(0, 1).contiguous().transpose(0, 1)

    opt, ref = _pair(shapes, dtype, card, seed=14, learning_rate=1e-3, weight_decay=0.01)
    assert _run_both(opt, ref, grad=grad) == 3
    _assert_equal(opt, ref)


@pytest.mark.cuda
def test_select_between_steps_matches_plain(card):
    shapes, kind, kw = _cell_shapes("cnnrnn_fit.s4_b32")
    opt, ref = _pair(shapes, torch.float32, card, kind, seed=15, **kw)
    assert _run_both(opt, ref, select=[0, 2, 3]) == 3
    assert opt.params[0].shape[0] == 3
    _assert_equal(opt, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,strided,launches", [(64, 0, 1), (65, 0, 2), (130, 0, 3),
                                                (20, 12, 1), (20, 13, 2)])
def test_launches_per_step(card, n, strided, launches):
    """One launch for each MAX_TENSORS tensors or MAX_STRIDED strided
    gradients (the first ``strided`` of ``n`` gradients transposed)."""
    shapes = [(3 + i % 5, 2 + i % 3) for i in range(n)]
    opt, ref = _pair(shapes, torch.float32, card, seed=16, learning_rate=1e-3,
                     weight_decay=0.01)
    count = iter(range(n * 3))
    grad = lambda g: g.t().contiguous().t() if next(count) % n < strided else g  # noqa: E731
    assert _run_both(opt, ref, grad=grad) == 3 * launches
    _assert_equal(opt, ref)


@pytest.mark.cuda
def test_empty_tensors_take_no_launch(card):
    opt, ref = _pair([(0,), (3, 0)], torch.float32, card, learning_rate=1e-3)
    assert _run_both(opt, ref) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["param_strided", "grad_six_dims", "grad_on_cpu",
                                  "float64_bfloat16"])
def test_card_step_raises(card, case):
    shapes = [(2,) * 6] if case == "grad_six_dims" else [(3, 4), (5,)]
    dtype = torch.float64 if case == "float64_bfloat16" else torch.float32
    opt, _ = _pair(shapes, dtype, card, learning_rate=1e-3,
                   moment_dtype="bfloat16" if case == "float64_bfloat16" else None)
    grads = [torch.zeros_like(p) for p in opt.params]
    if case == "param_strided":
        opt.params[0] = torch.zeros(4, 3, device=card).t()
    elif case == "grad_six_dims":
        grads[0] = torch.zeros((2,) * 6, device=card).permute(5, 4, 3, 2, 1, 0)
    elif case == "grad_on_cpu":
        grads[1] = grads[1].cpu()
    before = [p.clone() for p in opt.params]
    launches = optim.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        opt.step(grads)
    assert optim.LAUNCHES == launches
    assert all(torch.equal(p, q) for p, q in zip(opt.params, before))
