"""K1's sm_90a kernel (``ops/cuda_iir.lfilter_cuda``) against its plain
torch version and SciPy, on a card, across the shapes its launch code
branches on: every register instance (orders 1 to 16) and the generic
one, chunk lengths, ragged and single-chunk signals, rows whose starts are
not 16-byte aligned (the 4-byte copy path), leading dimensions and a
missing ``zi``.

Each case skips without a card. This file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_iir_card.py

Kernel vs plain version: 1e-6 absolute (outputs are O(1)); both round
each product and sum on its own in the same order, so they should agree
bit for bit. Against SciPy in float64: rtol/atol 1e-3, the tolerance of
the Pallas kernel's own SciPy test.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from decode_tonal_langauge_tpu_torch.ops import cuda_iir, iir


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check(b, a, x, zi, card):
    """Kernel vs plain version (1e-6) and SciPy (1e-3) on x: (..., T)."""
    xd = torch.from_numpy(x).to(card)
    zd = None if zi is None else torch.from_numpy(zi).to(card)
    before = cuda_iir.LAUNCHES
    got = cuda_iir.lfilter_cuda(b, a, xd, zi=zd)
    torch.cuda.synchronize()
    assert cuda_iir.LAUNCHES == before + 1
    plain = cuda_iir.lfilter_chunked_reference(b, a, xd, zi=zd)
    ref = sps.lfilter(b, a, x.astype(np.float64), axis=-1,
                      zi=None if zi is None else zi.astype(np.float64))
    if zi is None:
        got, plain, ref = (got,), (plain,), (ref,)
    for g, p, r in zip(got, plain, ref):
        assert g.shape == p.shape == r.shape
        np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.cpu().numpy(), r, rtol=1e-3, atol=1e-3)


def _inputs(order, rows, t, seed=0):
    """A Butterworth band of the given even order (or an order-1 lowpass),
    seeded x, and the steady-state zi times x[:, 0]."""
    if order == 1:
        b, a = sps.butter(1, 0.3)
    else:
        b, a = sps.butter(order // 2, [0.1, 0.4], btype="bandpass")
    x = np.random.default_rng(seed).standard_normal((rows, t)).astype(np.float32)
    zi = (sps.lfilter_zi(b, a)[None] * x[:, :1]).astype(np.float32)
    return b, a, x, zi


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 4, 6, 8])
def test_register_instances_iir(card, order):
    b, a, x, zi = _inputs(order, 70, 3 * cuda_iir.CHUNK + 100)
    _check(b, a, x, zi, card)


@pytest.mark.cuda
@pytest.mark.parametrize("order", range(1, cuda_iir.MAX_ORDER + 1))
def test_register_instances_fir(card, order):
    """Every register instance, with a well-conditioned filter: a FIR of
    order + 1 taps."""
    _check_fir(order + 1, card)


def _check_fir(taps, card, rows=33):
    b = sps.firwin(taps, 0.3)
    x = np.random.default_rng(1).standard_normal((rows, 2 * cuda_iir.CHUNK + 5)).astype(np.float32)
    zi = (0.1 * np.random.default_rng(2).standard_normal((rows, taps - 1))).astype(np.float32)
    _check(b, np.array([1.0]), x, zi, card)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [18, 20, 64, 512])
def test_generic_instance(card, taps):
    """FIRs of order 17 and above: the generic instance (512 taps: its
    state fits the shared memory of a 64-thread block, not 128)."""
    _check_fir(taps, card)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,t,chunk",
    [(9, 4 * 512, 512), (9, 4 * 512 + 4, 512), (9, 4 * 512 + 3, 512), (9, 300, 512),
     (9, 7, 512), (9, 5 * 32 + 1, 32), (130, 2 * 4096 + 37, cuda_iir.CHUNK)],
    ids=["exact", "ragged-aligned", "ragged-odd", "single-chunk", "shorter-than-window",
         "chunk-32", "two-pallas-blocks-ragged"],
)
def test_lengths_and_chunks(card, rows, t, chunk, monkeypatch):
    """Order 8 at chunk lengths and signal lengths around a chunk's and a
    window's edges; the last case is the Pallas kernel's two 4096-sample
    blocks plus a ragged tail on 130 rows."""
    monkeypatch.setattr(cuda_iir, "CHUNK", chunk)
    b, a, x, zi = _inputs(8, rows, t)
    _check(b, a, x, zi, card)


@pytest.mark.cuda
def test_unaligned_rows(card):
    """A contiguous x that starts 4 bytes past an aligned address: the
    kernel falls back to 4-byte copies and agrees all the same."""
    b, a, x, zi = _inputs(8, 5, 2 * cuda_iir.CHUNK)
    flat = torch.empty(x.size + 1, device=card)
    xd = flat[1:].view(x.shape)
    xd.copy_(torch.from_numpy(x))
    assert xd.is_contiguous() and xd.data_ptr() % 16
    zd = torch.from_numpy(zi).to(card)
    y, zf = cuda_iir.lfilter_cuda(b, a, xd, zi=zd)
    py, pzf = cuda_iir.lfilter_chunked_reference(b, a, xd, zi=zd)
    assert torch.equal(y, py) and torch.equal(zf, pzf)


@pytest.mark.cuda
def test_lead_dims_and_no_zi_through_lfilter(card):
    """(2, 3, T) through ``ops/iir.lfilter`` with a zi per row, then a
    stateless call of the wrapper."""
    b, a, x, zi = _inputs(8, 6, 9000)
    x3, zi3 = x.reshape(2, 3, -1), zi.reshape(2, 3, -1)
    y, zf = iir.lfilter(b, a, torch.from_numpy(x3).to(card), zi=torch.from_numpy(zi3).to(card))
    ref, ref_zf = sps.lfilter(b, a, x3.astype(np.float64), zi=zi3.astype(np.float64), axis=-1)
    np.testing.assert_allclose(y.cpu().numpy(), ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(zf.cpu().numpy(), ref_zf, rtol=1e-3, atol=1e-3)
    _check(b, a, x3, None, card)
