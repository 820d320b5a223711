"""The GRU-CTC decoder on the port: the GRU's sequence and step ops
(``ops/gru.py``) and their sm_90a kernel (``csrc/gru_step.cu``), the CTC
loss (``training/ctc.py``), ``GRUDecoder`` (``models/sequence.py``),
``Adam`` and ``SequenceTrainer``, held against the benchmark's plain
reference (``benchmark/reference/gru_ctc.py``, imported, not copied) and
against ``torch.nn.GRU`` / ``F.ctc_loss``.

On the CPU at a small cut: 16 features, hidden 32, 2 bidirectional
layers, patches of 4 bins at stride 2, 3 days, batch 4, sentences of
20-40 bins. Tolerances (each test says which it takes):

- float64 against the reference: 1e-10 relative, or absolute on values
  O(1): the two sum the same products in other orders (a GEMM for the
  time-batched projections, a matvec a cell), ~1e-15 each over a few
  hundred terms and steps; the Gaussian kernel, computed in float32 by
  the port (as the source computes it) and in float64 by the reference,
  moves the whole model's outputs by up to ~1e-8, so the model's checks
  take 1e-6;
- float32 trainer steps against the float64 reference: losses within
  2e-6 relative and each tensor's change after three Adam steps within
  1e-6 a weight of its norm (float32 rounding, 6e-8 relative, through
  sums of up to ~1e3 terms and three steps; read 1.5e-7 and 2e-8 at this
  cut; Adam's eps of 0.1 keeps its steps from amplifying the difference);
- on a card, the kernel against the plain steps run on the same card:
  float32 5e-5 absolute (sums of up to 3H = 3,072 products in another
  order, carried through a few steps), float64 1e-12.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_gru_ctc.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import gru_ctc as ref
from benchmark.reference.precision import F64
from decode_tonal_langauge_tpu_torch.models.factory import build_sequence_model
from decode_tonal_langauge_tpu_torch.ops import gru
from decode_tonal_langauge_tpu_torch.runtime import profiling
from decode_tonal_langauge_tpu_torch.training.ctc import ctc_loss, edit_distance, greedy_decode
from decode_tonal_langauge_tpu_torch.training.optim import Adam
from decode_tonal_langauge_tpu_torch.training.sequence_trainer import SequenceTrainer

M = {"arch": "GRUDecoder", "neural_dim": 16, "n_classes": 40, "hidden_dim": 32, "layer_dim": 2,
     "n_days": 3, "kernel_len": 4, "stride_len": 2, "smooth_width": 2.0, "dropout": 0.4,
     "bidirectional": True}
BATCH = 4
HYPER = {"learning_rate": 0.02, "weight_decay": 1e-5, "b1": 0.9, "b2": 0.999, "eps": 0.1}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dtype=torch.float32, seed=0):
    model = build_sequence_model(M["arch"], **{k: v for k, v in M.items() if k != "arch"})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dtype)


def _sentences(n, seed=0, t_max=40):
    """``n`` sentences of 20-40 bins: features, lengths, phoneme ids
    (floor(T / 11) each), their lengths, days."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, t_max + 1, n)
    tl = lengths // 11
    x = np.zeros((n, t_max, M["neural_dim"]), np.float32)
    targets = np.zeros((n, tl.max()), np.int64)
    for i in range(n):
        targets[i, :tl[i]] = rng.integers(1, M["n_classes"] + 1, tl[i])
        x[i, :lengths[i]] = rng.standard_normal((lengths[i], M["neural_dim"]))
    return {"x": x, "lengths": lengths, "targets": targets, "target_lengths": tl,
            "day": rng.integers(0, M["n_days"], n)}


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- the GRU ops --------------------------------------------------------------

def _layer_inputs(seed=0, dtype=torch.float64, n_dir=2, n_in=6, hid=5, b=3, t=7):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: (0.5 * torch.randn(*s, generator=g, dtype=dtype)).requires_grad_()  # noqa: E731
    return (mk(b, t, n_in), mk(n_dir, 3 * hid, n_in), mk(n_dir, 3 * hid, hid),
            mk(n_dir, 3 * hid), mk(n_dir, 3 * hid))


@pytest.mark.parametrize("n_dir", [1, 2])
def test_layer_forward_and_every_gradient_equal_the_reference_cells(n_dir):
    """float64, 1e-12 absolute (values and gradients O(1))."""
    x, wi, wh, bi, bh = _layer_inputs(n_dir=n_dir)
    y = gru.gru_layer(x, wi, wh, bi, bh)
    want = torch.cat([ref.gru_direction(x, wi[d], wh[d], bi[d], bh[d], F64, reverse=bool(d))
                      for d in range(n_dir)], dim=-1)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-12)
    d_out = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, wi, wh, bi, bh), d_out)
    exp = torch.autograd.grad(want, (x, wi, wh, bi, bh), d_out)
    for a, b in zip(got, exp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_stack_equals_torch_nn_gru_and_loads_its_state_dict():
    """float64, 1e-12: the parameter names, shapes and outputs are
    ``nn.GRU``'s (batch first, bidirectional, two layers)."""
    torch.manual_seed(0)
    theirs = torch.nn.GRU(6, 5, 2, batch_first=True, bidirectional=True).double()
    ours = gru.TimeBatchedGRU(6, 5, 2, 0.0, True).double()
    ours.load_state_dict(theirs.state_dict())
    x = torch.randn(3, 7, 6, dtype=torch.float64)
    torch.testing.assert_close(ours(x), theirs(x)[0], rtol=0, atol=1e-12)


def test_gradcheck_float64():
    assert torch.autograd.gradcheck(lambda *a: gru.GRUSequence.apply(*a)[0],
                                    _layer_inputs(b=2, t=4, hid=3, n_in=4))


@pytest.mark.parametrize("keep", [True, False])
def test_vmap_over_three_seeds_equals_three_calls(keep):
    """vmap folds its dimension into the seed axis: equal to a call a seed
    within 1e-6 (float32, values O(1): the CPU's batched GEMM may block a
    batch of 6 otherwise than one of 2, so the last bits may differ)."""
    g = torch.Generator().manual_seed(1)
    xg = torch.randn(3, 2, 2, 5, 12, generator=g)
    wt = torch.randn(3, 2, 4, 12, generator=g) * 0.3
    bh = torch.randn(3, 2, 12, generator=g)
    hs, rzn = torch.func.vmap(lambda a, b, c: gru.gru_scan(a, b, c, keep))(xg, wt, bh)
    for i in range(3):
        h1, r1 = gru.gru_scan(xg[i], wt[i], bh[i], keep)
        torch.testing.assert_close(hs[i], h1, rtol=0, atol=1e-6)
        if keep:
            torch.testing.assert_close(rzn[i], r1, rtol=0, atol=1e-6)
            dgx, dgh = torch.func.vmap(gru.gru_scan_backward)(hs * 0 + 1, wt, hs, rzn)
            a, b = gru.gru_scan_backward(torch.ones_like(h1), wt[i], h1, r1)
            torch.testing.assert_close(dgx[i], a, rtol=0, atol=1e-6)
            torch.testing.assert_close(dgh[i], b, rtol=0, atol=1e-6)


def test_dropout_between_layers_draws_the_references_masks():
    """The stack's dropouts draw, from the trainer's generator, the masks
    the reference draws again by its rule (``ref.draws``): a forward in
    train mode with both equals the reference given those masks, float64
    1e-6 (the Gaussian kernel's precision, module docstring)."""
    model = _model(torch.float64)
    model.train()
    gen = torch.Generator().manual_seed(5)
    for d in model.gru_decoder.dropouts:
        d.generator = gen
    s = _sentences(BATCH)
    x = torch.as_tensor(s["x"], dtype=torch.float64)
    day = torch.as_tensor(s["day"])
    out = model(x, day)
    shapes = ref.dropout_shapes(M, BATCH, x.shape[1])
    g = torch.Generator().manual_seed(5)
    masks = {k: torch.empty(v, dtype=torch.float32).bernoulli_(1 - M["dropout"], generator=g)
             for k, v in shapes.items()}
    want = ref.forward(_params(model), x, day, M, F64, masks=masks)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    assert set(masks) == {"gru.l0"} and masks["gru.l0"].shape == (BATCH, out.shape[1], 64)


# -- the CTC loss ---------------------------------------------------------------

def _ctc_case(seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(5, 14, 7, generator=g, dtype=torch.float64, requires_grad=True)
    targets = torch.randint(1, 7, (5, 5), generator=g)
    targets[0, :3] = 2  # repeats need a blank between them
    return logits, targets, [14, 10, 3, 11, 14], [5, 3, 4, 2, 1]  # trial 2 is infeasible


def test_ctc_equals_the_reference_alpha_recursion_in_float64():
    """Each trial's loss over its target length and the gradient, 1e-10;
    the infeasible trial counts 0 and takes no gradient (``zero_infinity``)."""
    logits, targets, il, tl = _ctc_case()
    per = ctc_loss(logits, targets, il, tl)
    nll = ref.ctc_nll(torch.log_softmax(logits, -1), targets, il, tl)
    assert torch.isinf(nll[2]) and per[2] == 0
    want = torch.where(torch.isinf(nll), torch.zeros_like(nll), nll) / torch.tensor(tl)
    torch.testing.assert_close(per, want, rtol=1e-10, atol=0)
    w = torch.tensor([1.0, 0.5, 1.0, 1.0, 0.0], dtype=torch.float64)
    loss = (per * w).sum() / w.sum()
    want_loss = ref.ctc_batch_loss(logits, targets, il, tl, w, w.sum())
    torch.testing.assert_close(loss, want_loss, rtol=1e-10, atol=0)
    g1, = torch.autograd.grad(loss, logits)
    g2, = torch.autograd.grad(want_loss, logits)
    torch.testing.assert_close(g1, g2, rtol=0, atol=1e-10)
    assert g1[2].abs().max() == 0 and g1[4].abs().max() == 0


def test_ctc_mean_is_torch_ctc_loss_mean():
    """``CTCLoss(blank=0, reduction="mean", zero_infinity=True)``, the
    source's loss, is the mean of ours: 1e-12."""
    logits, targets, il, tl = _ctc_case(3)
    ours = ctc_loss(logits, targets, il, tl).mean()
    theirs = F.ctc_loss(torch.log_softmax(logits, -1).transpose(0, 1), targets,
                        torch.tensor(il), torch.tensor(tl), blank=0, reduction="mean",
                        zero_infinity=True)
    torch.testing.assert_close(ours, theirs, rtol=1e-12, atol=0)
    torch.testing.assert_close(torch.autograd.grad(ours, logits)[0],
                               torch.autograd.grad(theirs, logits)[0], rtol=0, atol=1e-12)


def test_ctc_gradcheck():
    logits, targets, il, tl = _ctc_case(4)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0, 0.5], dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda z: ctc_loss(z, targets, il, tl) * w, (logits,))


def test_greedy_decode_and_edit_distance():
    logits = torch.full((1, 7, 4), -5.0)
    for t, c in enumerate([0, 2, 2, 0, 2, 3, 3]):
        logits[0, t, c] = 5.0
    assert greedy_decode(logits, [7]) == [[2, 2, 3]]
    assert greedy_decode(logits, [3]) == [[2]]
    assert edit_distance([2, 2, 3], [2, 3]) == 1
    assert edit_distance([], [1, 2]) == 2 and edit_distance([1, 2, 3], [1, 2, 3]) == 0


# -- the model -----------------------------------------------------------------

def test_model_has_the_published_parameter_count_and_the_references_names():
    with torch.device("meta"):
        full = build_sequence_model("GRUDecoder", neural_dim=256, n_classes=40, hidden_dim=1024,
                                    layer_dim=5, n_days=24, kernel_len=32, stride_len=4,
                                    dropout=0.4, bidirectional=True)
    assert sum(p.numel() for p in full.parameters()) == 133_845_033
    spec = {n: s for n, s, *_ in ref.param_spec(M)}
    model = _model()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec


def test_unfold_is_channel_major_as_torch_unfold():
    """The patches' feature index is ``c * kernel_len + k``, as the
    source's ``nn.Unfold((kernel_len, 1), stride)`` orders it."""
    y = torch.randn(2, 13, 3)
    ours = y.unfold(1, 4, 2).reshape(2, -1, 12)
    theirs = torch.nn.Unfold((4, 1), stride=2)(y.transpose(1, 2)[..., None]).transpose(1, 2)
    assert torch.equal(ours, theirs)


def test_model_loss_and_gradients_equal_the_reference():
    """Seeded random weights (the harness's kinds, not the source's
    init), eval mode, float64: the loss within 1e-6 relative and every
    gradient within 1e-6 absolute (the Gaussian kernel's precision)."""
    from benchmark.harness import weights

    model = _model(torch.float64)
    w = {k: v.double() for k, v in weights.draw(ref.param_spec(M), 11, "cpu").items()}
    model.load_state_dict(w)
    model.eval()
    s = _sentences(BATCH, seed=2)
    x = torch.as_tensor(s["x"], dtype=torch.float64)
    day = torch.as_tensor(s["day"])
    il = model.output_lengths(torch.as_tensor(s["lengths"])).tolist()
    assert il == ref.input_lengths(M, s["lengths"])
    targets = torch.as_tensor(s["targets"])
    tl = s["target_lengths"].tolist()
    loss = ctc_loss(model(x, day), targets, il, tl).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    p = {k: v.clone().requires_grad_() for k, v in w.items()}
    ones = torch.ones(BATCH, dtype=torch.float64)
    want = ref.ctc_batch_loss(ref.forward(p, x, day, M, F64), targets, il, tl, ones, ones.sum())
    exp = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for (name, _), g in zip(model.named_parameters(), grads):
        torch.testing.assert_close(g, exp[name], rtol=0, atol=1e-6, msg=name)


# -- Adam and the trainer --------------------------------------------------------

def test_adam_equals_torch_optim_adam_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    ps = [torch.randn(5, 3, generator=g), torch.randn(4, generator=g)]
    theirs = [p.clone().requires_grad_() for p in ps]
    opt = torch.optim.Adam(theirs, lr=0.02, betas=(0.9, 0.999), eps=0.1, weight_decay=1e-5)
    ours = Adam(ps, 0.02, 1e-5, eps=0.1)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in ps]
        for q, gr in zip(theirs, grads):
            q.grad = gr.clone()
        opt.step()
        ours.step(grads)
    for p, q in zip(ps, theirs):
        assert torch.equal(p, q.detach())


def _trainer(seed=7):
    t = SequenceTrainer(_model(), batch_size=BATCH, seed=seed, device="cpu", **HYPER)
    t.init()
    return t


def test_three_trainer_steps_equal_the_references_adam_steps():
    """Three float32 ``train_step``s from seeded weights against the
    reference's Adam-L2 steps in float64, given the augmentation and
    dropout the reference draws again by the trainer's rule: losses 2e-6
    relative, changes 1e-6 a weight (module docstring)."""
    from benchmark.harness import weights

    t = _trainer()
    w0 = weights.draw(ref.param_spec(M), 3, "cpu")
    t.model.load_state_dict(w0)
    s = _sentences(3 * BATCH, seed=4)
    data = t.device_data(s["x"], s["lengths"], s["targets"], s["target_lengths"], s["day"])
    steps = [torch.arange(k * BATCH, (k + 1) * BATCH) for k in range(3)]
    losses = [float(t.train_step(*t.batch(data, rows))) for rows in steps]

    n_bins = [int(s["lengths"][r.numpy()].max()) for r in steps]
    draws = ref.draws(t.seed, [ref.dropout_shapes(M, BATCH, n) for n in n_bins],
                      [(BATCH, n, M["neural_dim"]) for n in n_bins], M["dropout"], "cpu")
    batches = []
    for rows, n, dr in zip(steps, n_bins, draws):
        r = rows.numpy()
        x = torch.as_tensor(s["x"][r, :n]) + dr["noise"] * 0.8 + dr["offset"] * 0.2
        batches.append((x, torch.as_tensor(s["day"][r]), torch.as_tensor(s["targets"][r]),
                        ref.input_lengths(M, s["lengths"][r]), s["target_lengths"][r].tolist(),
                        torch.ones(BATCH, dtype=torch.float64),
                        {k: v for k, v in dr.items() if k.startswith("gru.")}))
    forward = lambda pp, x, day, masks: ref.forward(pp, x, day, M, F64, masks=masks)  # noqa: E731
    res = ref.follow_steps(forward, {k: v.double() for k, v in w0.items()}, batches, HYPER,
                           F64, "cpu")
    np.testing.assert_allclose(losses, res["loss"], rtol=2e-6)
    # each tensor's change after the steps, by its norm: within 1e-6 a weight
    change = {k: float((v.double() - w0[k].double()).norm())
              for k, v in t.model.state_dict().items()}
    for k, c in res["change"].items():
        assert abs(change[k] - c) <= 1e-6 * np.sqrt(w0[k].numel()), k


def test_trainer_batch_cuts_to_the_longest_sentence_and_weighs_padding_zero():
    t = _trainer()
    s = _sentences(6, seed=1)
    data = t.device_data(s["x"], s["lengths"], s["targets"], s["target_lengths"], s["day"])
    assert len(data) == 8 and data.w.tolist() == [1] * 6 + [0, 0]
    x, lengths, targets, tl, day, w, total = t.batch(data, torch.tensor([5, 6, 1, 2]))
    assert x.shape[1] == int(max(s["lengths"][[5, 0, 1, 2]])) and float(total) == 3.0
    assert lengths.device.type == "cpu" and tl.device.type == "cpu"


def test_a_train_step_runs_one_step_op_a_time_step(monkeypatch):
    """Each GRU layer runs L forward steps and L - 1 reverse steps after
    one first delta (L the batch's frames), both directions in each: what
    ``FORWARD_LAUNCHES``, ``REVERSE_LAUNCHES`` and ``DELTA_LAUNCHES`` count
    on a card (the card test below)."""
    t = _trainer()
    s = _sentences(BATCH, seed=3)
    data = t.device_data(s["x"], s["lengths"], s["targets"], s["target_lengths"], s["day"])
    args = t.batch(data, torch.arange(BATCH))
    frames = t.model.frames(args[0].shape[1])
    calls = dict.fromkeys(("gru_step", "gru_step_backward", "gru_delta_init"), 0)
    for name in calls:
        op = getattr(torch.ops.tonal, name)

        def counted(*a, _op=op, _name=name):
            calls[_name] += 1
            return _op(*a)

        monkeypatch.setattr(torch.ops.tonal, name, counted)
    t.train_step(*args)
    layers = M["layer_dim"]
    assert calls == {"gru_step": layers * frames, "gru_step_backward": layers * (frames - 1),
                     "gru_delta_init": layers}


def test_spans_of_a_train_step():
    t = _trainer()
    s = _sentences(BATCH, seed=3)
    data = t.device_data(s["x"], s["lengths"], s["targets"], s["target_lengths"], s["day"])
    with profiling.recording() as rec:
        t.train_step(*t.batch(data, torch.arange(BATCH)))
    names = [sp.name for sp in rec.spans]
    assert {"trainer.step", "gru.forward", "gru.reverse", "gru.weight_grads", "ctc.loss",
            "ctc.grad", "optim.adam"} <= set(names)
    assert names.count("gru.forward") == names.count("gru.reverse") == M["layer_dim"]


def test_fit_resume_equals_the_straight_fit(tmp_path):
    """Two epochs, then a third from the saved state, equal three epochs
    straight: weights, Adam's moments and history bit for bit."""
    train, val = _sentences(8, seed=5), _sentences(4, seed=6)
    a = SequenceTrainer(_model(), batch_size=BATCH, max_epochs=3, seed=2, device="cpu", **HYPER)
    full = a.fit(train, val)
    b = SequenceTrainer(_model(), batch_size=BATCH, max_epochs=2, seed=2, device="cpu", **HYPER)
    b.fit(train, val, checkpoint_dir=str(tmp_path / "state"))
    c = SequenceTrainer(_model(), batch_size=BATCH, max_epochs=3, seed=2, device="cpu", **HYPER)
    resumed = c.fit(train, val, checkpoint_dir=str(tmp_path / "state"), resume=True)
    assert [r["epoch"] for r in resumed] == [0, 1, 2]
    for ra, rc in zip(full, resumed):
        assert ra == pytest.approx(rc, rel=0, abs=0)
    for pa, pc in zip(a.model.parameters(), c.model.parameters()):
        assert torch.equal(pa, pc)
    assert all(0.0 <= r["val/per"] and np.isfinite(r["val/loss"]) for r in full)


# -- the kernel on a card ---------------------------------------------------------

def _scan_inputs(s, b, t, hid, dtype, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    xg = torch.randn(s, b, t, 3 * hid, generator=g, device=device).to(dtype)
    wt = (torch.randn(s, hid, 3 * hid, generator=g, device=device) / hid ** 0.5).to(dtype)
    bh = (0.1 * torch.randn(s, 3 * hid, generator=g, device=device)).to(dtype)
    d = torch.randn(t, s, b, hid, generator=g, device=device).to(dtype)
    return xg, wt, bh, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 5e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(2, 64, 6, 1024), (2, 1, 5, 1024), (2, 100, 4, 512),
                                   (3, 48, 4, 66)])
def test_kernel_equals_plain_on_card(card, shape, dtype, atol):
    """The cell's shape (2 directions x 64 rows x 1,024 units) and the
    other tiles (one row; the GEMM tile; rows not 16-byte aligned), forward
    and reverse, against the plain steps on the card; the launch counters
    equal the steps run."""
    s, b, t, hid = shape
    xg, wt, bh, d = _scan_inputs(s, b, t, hid, dtype, card)
    before = (gru.FORWARD_LAUNCHES, gru.REVERSE_LAUNCHES, gru.DELTA_LAUNCHES)
    hs, rzn = gru.gru_scan(xg, wt, bh, True)
    hp, rp = gru.gru_scan_plain(xg, wt, bh, True)
    dgx, dgh = gru.gru_scan_backward(d, wt, hp, rp)
    gx, gh = gru.gru_scan_backward_plain(d, wt, hp, rp)
    after = (gru.FORWARD_LAUNCHES, gru.REVERSE_LAUNCHES, gru.DELTA_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == (t, t - 1, 1)
    for got, want in ((hs, hp), (rzn, rp), (dgx, gx), (dgh, gh)):
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_train_step_on_card_equals_cpu(card):
    """One float32 step of the small decoder on the card and on the CPU:
    loss within 1e-5 relative (the kernels' and cuBLAS's summation
    orders), the augmentation and dropout aside (drawn on each device by
    its own generator, so both are set to nought here)."""
    s = _sentences(BATCH, seed=8)
    out = []
    for device in ("cpu", card):
        t = SequenceTrainer(_model(), batch_size=BATCH, seed=1, device=device,
                            white_noise_sd=0.0, constant_offset_sd=0.0, **HYPER)
        t.init()
        t.model.eval()
        for d in t.model.gru_decoder.dropouts:
            d.p = 0.0
        data = t.device_data(s["x"], s["lengths"], s["targets"], s["target_lengths"], s["day"])
        out.append(float(t.train_step(*t.batch(data, torch.arange(BATCH)))))
    assert out[1] == pytest.approx(out[0], rel=1e-5)
