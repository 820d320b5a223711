"""The port's IIR ops (``decode_tonal_langauge_tpu_torch/ops/iir.py``,
``ops/cuda_iir.py``) against the JAX package and SciPy.

Inputs come from a seeded numpy generator and go through both packages;
tolerances are those of ``tests/test_ops_signal.py`` (the JAX ops'
oracle tests), unless a case says otherwise.
"""

import warnings

import numpy as np
import pytest
import scipy.signal as sps
import torch

from decode_tonal_langauge_tpu.ops import iir as jiir
from decode_tonal_langauge_tpu.ops.pallas_iir import _CHUNK, lfilter_pallas
from decode_tonal_langauge_tpu_torch.ops import cuda_iir
from decode_tonal_langauge_tpu_torch.ops import iir as tiir

BAND8 = sps.butter(4, [0.1, 0.4], btype="bandpass")  # order-8 tf form


def _sig(c, t, seed=0):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=atol)


class TestK1Plain:
    """The plain version of the DF2T kernel (what the CPU runs) against
    the Pallas kernel in interpret mode and SciPy."""

    @pytest.mark.parametrize("with_zi", [True, False])
    def test_order8_matches_pallas_and_scipy(self, with_zi):
        b, a = BAND8
        x = _sig(3, 1000)
        zi = sps.lfilter_zi(b, a)[None] * x[:, :1].astype(np.float64) if with_zi else None
        ref = sps.lfilter(b, a, x.astype(np.float64), zi=zi, axis=-1)
        if with_zi:
            zi32 = zi.astype(np.float32)
            ours, zf = cuda_iir.lfilter_reference(b, a, _t(x), zi=_t(zi32))
            pal, pal_zf = lfilter_pallas(b, a, x, zi=zi32, interpret=True)
            _close(zf, ref[1], 1e-3, 1e-3)
            _close(zf, pal_zf, 1e-3, 1e-3)
            ref = ref[0]
        else:
            ours = cuda_iir.lfilter_reference(b, a, _t(x))
            pal = lfilter_pallas(b, a, x, interpret=True)
        _close(ours, ref, 1e-3, 1e-3)
        _close(ours, pal, 1e-3, 1e-3)

    def test_chunk_boundary_state(self):
        """4096 + 37 samples: two Pallas grid steps and a ragged tail; zf
        must be the state after the last real sample in both."""
        b, a = sps.butter(2, 0.3)
        x = _sig(1, _CHUNK + 37)
        zi = np.zeros((1, 2), np.float32)
        ours, zf = cuda_iir.lfilter_reference(b, a, _t(x), zi=_t(zi))
        pal, pal_zf = lfilter_pallas(b, a, x, zi=zi, interpret=True)
        ref, ref_zf = sps.lfilter(b, a, x.astype(np.float64), zi=zi, axis=-1)
        _close(ours, ref, 1e-3, 1e-3)
        _close(zf, ref_zf, 1e-3, 1e-3)
        _close(ours, pal, 1e-3, 1e-3)
        _close(zf, pal_zf, 1e-3, 1e-3)

    def test_wrapper_uses_plain_version_on_cpu(self):
        b, a = BAND8
        x = _sig(2, cuda_iir.CHUNK + 100)  # two chunks
        zi = np.ones((2, 8), np.float32)
        before = cuda_iir.LAUNCHES
        y, zf = cuda_iir.lfilter_cuda(b, a, _t(x), zi=_t(zi))
        ry, rzf = cuda_iir.lfilter_chunked_reference(b, a, _t(x), zi=_t(zi))
        assert torch.equal(y, ry) and torch.equal(zf, rzf)
        assert cuda_iir.LAUNCHES == before  # no kernel launch on the CPU

    def test_pure_gain(self):
        x = _sig(2, 50)
        y = cuda_iir.lfilter_reference([2.0], [4.0], _t(x))
        _close(y, x * 0.5, 0, 0)


CHUNK_FILTERS = {
    "band4": sps.butter(2, [0.1, 0.4], btype="bandpass"),
    "band6": sps.butter(3, [0.1, 0.4], btype="bandpass"),
    "band8": BAND8,
    "fir20": (sps.firwin(20, 0.3), np.array([1.0])),  # order 19
}


def _chunk_inputs(name, t, with_zi, rows=2):
    """Seeded x and zi: the steady state times x[0] for an IIR band, a
    small random state for the FIR."""
    b, a = CHUNK_FILTERS[name]
    x = _sig(rows, t)
    if not with_zi:
        return b, a, x, None
    if len(a) == 1:
        zi = 0.1 * np.random.default_rng(1).standard_normal((rows, len(b) - 1))
    else:
        zi = sps.lfilter_zi(b, a)[None] * x[:, :1]
    return b, a, x, zi.astype(np.float32)


class TestK1Chunked:
    """The plain version of the three-pass chunked kernel (what the CPU
    runs) against JAX ``ops.iir.lfilter`` (its serial scan at these
    lengths), SciPy in float64 and the serial plain recurrence. Tolerance
    rtol/atol 1e-3, that of the Pallas kernel's own SciPy test
    (``tests/test_ops_signal.py``)."""

    @pytest.mark.parametrize("with_zi", [True, False], ids=["zi", "no-zi"])
    @pytest.mark.parametrize(
        "t,chunk",
        [(3 * 64, 64), (3 * 64 + 17, 64), (64 - 9, 64),
         (2 * cuda_iir.CHUNK + 37, cuda_iir.CHUNK)],
        ids=["exact", "ragged", "single", "default-chunk"],
    )
    @pytest.mark.parametrize("name", list(CHUNK_FILTERS))
    def test_matches_jax_scipy_and_serial(self, name, t, chunk, with_zi, monkeypatch):
        monkeypatch.setattr(cuda_iir, "CHUNK", chunk)
        b, a, x, zi = _chunk_inputs(name, t, with_zi)
        zi_t = None if zi is None else _t(zi)
        ours = cuda_iir.lfilter_chunked_reference(b, a, _t(x), zi=zi_t)
        serial = cuda_iir.lfilter_reference(b, a, _t(x), zi=zi_t)
        theirs = jiir.lfilter(b, a, x, zi=zi)
        ref = sps.lfilter(b, a, x.astype(np.float64), axis=-1,
                          zi=None if zi is None else zi.astype(np.float64))
        if not with_zi:
            ours, serial, theirs, ref = ((v, None) for v in (ours, serial, theirs, ref))
        for y, zf in (theirs, ref, serial):
            _close(ours[0], y, 1e-3, 1e-3)
            if with_zi:
                _close(ours[1], zf, 1e-3, 1e-3)

    @pytest.mark.parametrize("name", ["band8", "fir20"])
    def test_single_chunk_is_the_serial_recurrence(self, name):
        """One chunk enters with zi itself: pass 3 is then the serial
        recurrence, to the bit."""
        b, a, x, zi = _chunk_inputs(name, cuda_iir.CHUNK - 9, True)
        y, zf = cuda_iir.lfilter_chunked_reference(b, a, _t(x), zi=_t(zi))
        sy, szf = cuda_iir.lfilter_reference(b, a, _t(x), zi=_t(zi))
        assert torch.equal(y, sy) and torch.equal(zf, szf)

    @pytest.mark.parametrize("chunk", [1, 64, 256])
    @pytest.mark.parametrize("name", ["band4", "band8", "fir20"])
    def test_carry_matrix_matches_stepping(self, name, chunk):
        """P against a step-by-step f64 zero-input run from a random state
        (the same map summed in another order: rtol 1e-9), and against
        A^chunk of the JAX package's state-space form by repeated squaring
        (cancellation in the transient growth of A^k: 1e-8 of max |P|)."""
        _, an = cuda_iir._normalised(*CHUNK_FILTERS[name])
        P = cuda_iir.carry_matrix(tuple(an.tolist()), chunk)
        a32 = an.astype(np.float32).astype(np.float64)  # the kernel's a
        m = an.size - 1
        s0 = np.random.default_rng(2).standard_normal(m)
        s = s0.copy()
        for _ in range(chunk):
            y = s[0]  # y = b0 * 0 + s_0
            s = np.array([(s[i + 1] if i + 1 < m else 0.0) - a32[i + 1] * y
                          for i in range(m)])
        np.testing.assert_allclose(P @ s0, s, rtol=1e-9, atol=1e-18)
        A, _, _ = jiir._ba_state_space(np.r_[1.0, np.zeros(m)], a32)
        np.testing.assert_allclose(P, np.linalg.matrix_power(A, chunk), rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(P).max()))


class TestRoutes:
    """Every ``lfilter`` / ``filtfilt`` / ``sosfilt`` / ``butter_filter``
    route, short and above IIR_SCAN_LIMIT, against JAX ``ops.iir``."""

    def test_scan_limit_matches(self):
        assert tiir.IIR_SCAN_LIMIT == jiir.IIR_SCAN_LIMIT

    @pytest.mark.parametrize(
        "order_band,t,with_zi,tol",
        [
            ("band8", 1500, False, (1e-3, 5e-4)),  # short scan
            ("low2", 400, True, (1e-3, 1e-4)),  # short scan with zi
            ("band2", 20000, False, (1e-3, 1e-4)),  # blocked
            ("low2", 20001, True, (1e-3, 1e-3)),  # blocked + ragged tail
            ("band8", 20000, False, (1e-3, 1e-4)),  # blocked biquad cascade
            ("band8", 8300, True, (1e-3, 1e-3)),  # K1 route (plain on CPU)
        ],
    )
    def test_lfilter(self, order_band, t, with_zi, tol):
        b, a = {
            "band8": BAND8,
            "band2": sps.butter(2, [0.1, 0.4], btype="bandpass"),
            "low2": sps.butter(2, 0.2),
        }[order_band]
        x = _sig(2, t)
        zi = None
        if with_zi:
            zi = (sps.lfilter_zi(b, a)[None] * x[:, :1]).astype(np.float32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ours = tiir.lfilter(b, a, _t(x), zi=None if zi is None else _t(zi))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # JAX warns on the same route
            theirs = jiir.lfilter(b, a, x, zi=zi)
        ref = sps.lfilter(b, a, x.astype(np.float64), zi=zi, axis=-1)
        if with_zi:
            (ours, zf), (theirs, jzf), (ref, ref_zf) = ours, theirs, ref
            _close(zf, jzf, 1e-2, 1e-3)
            _close(zf, ref_zf, 1e-2, 1e-3)
        _close(ours, theirs, *tol)
        _close(ours, ref, *tol)
        # In f32 the K1 route runs the chunked scan, on the CPU too: no
        # route here runs the warned-about timestep scan.
        assert not any("timestep scan" in str(w.message) for w in caught)

    def test_lfilter_warns_only_for_the_serial_scan(self):
        """Above IIR_SCAN_LIMIT with zi at order 8, f32 takes the chunked
        scan without a warning; f64 runs the serial scan and warns."""
        b, a = BAND8
        x = _sig(2, 8300)
        zi = sps.lfilter_zi(b, a)[None] * x[:, :1]
        ref, ref_zf = sps.lfilter(b, a, x.astype(np.float64), zi=zi, axis=-1)
        for dtype, warns in ((torch.float32, False), (torch.float64, True)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                y, zf = tiir.lfilter(b, a, _t(x).to(dtype), zi=_t(zi).to(dtype))
            assert y.dtype == dtype
            assert any("timestep scan" in str(w.message) for w in caught) == warns
            _close(y, ref, 1e-3, 1e-3)
            _close(zf, ref_zf, 1e-3, 1e-3)

    def test_lfilter_axis(self):
        b, a = BAND8
        x = _sig(300, 3)
        _close(tiir.lfilter(b, a, _t(x), axis=0), jiir.lfilter(b, a, x, axis=0),
               1e-3, 5e-4)

    @pytest.mark.parametrize("t", [2000, 20000])
    def test_filtfilt(self, t):
        b, a = sps.butter(4, [0.05, 0.45], btype="bandpass")
        x = _sig(2, t)
        ours = tiir.filtfilt(b, a, _t(x)).numpy()
        _close(ours, jiir.filtfilt(b, a, x), 5e-3, 5e-4)
        ref = sps.filtfilt(b, a, x.astype(np.float64), axis=-1)
        # the long path is frequency-domain: edge transients differ from
        # SciPy's odd-padding recursion, the interior matches
        edge = 300 if t > tiir.IIR_SCAN_LIMIT else 0
        _close(ours[:, edge : t - edge], ref[:, edge : t - edge], 5e-3, 5e-4)

    def test_filtfilt_rejects_short(self):
        b, a = BAND8
        with pytest.raises(ValueError, match="padlen"):
            tiir.filtfilt(b, a, _t(_sig(1, 20)))

    @pytest.mark.parametrize("t", [1200, 20000])
    def test_sosfilt(self, t):
        sos = sps.butter(4, [0.1, 0.4], btype="bandpass", output="sos")
        x = _sig(2, t)
        ours = tiir.sosfilt(sos, _t(x))
        _close(ours, jiir.sosfilt(sos, x), 1e-3, 1e-4)
        _close(ours, sps.sosfilt(sos, x.astype(np.float64), axis=-1), 1e-3, 1e-4)

    @pytest.mark.parametrize(
        "t,freqs,fs,ftype,causal",
        [
            (1600, 50.0, 400.0, "lowpass", False),
            (1600, (70.0, 150.0), 400.0, "bandpass", True),
            (20000, (1.0, 100.0), 1000.0, "bandpass", False),  # near-DC, FFT
            (20000, (70.0, 150.0), 400.0, "bandpass", True),
        ],
    )
    def test_butter_filter(self, t, freqs, fs, ftype, causal):
        x = _sig(2, t)
        ours = tiir.butter_filter(_t(x), freqs, fs, causal=causal, filter_type=ftype)
        theirs = jiir.butter_filter(x, freqs, fs, causal=causal, filter_type=ftype)
        _close(ours, theirs, 5e-3, 5e-4)

    def test_design_helpers_match(self):
        for args in ((4, (70.0, 150.0), 400.0), (2, 30.0, 400.0, "lowpass")):
            for out, theirs in zip(tiir.butter_design(*args),
                                   jiir.butter_design(*args)):
                np.testing.assert_array_equal(out, theirs)
        b, a = BAND8
        np.testing.assert_array_equal(tiir.lfilter_zi(b, a), jiir.lfilter_zi(b, a))

    def test_block_tables_match(self):
        b, a = sps.butter(2, 0.2)
        for ours, theirs in zip(tiir._block_iir_tables(b, a, 64),
                                jiir._block_iir_tables(b, a, 64)):
            np.testing.assert_array_equal(ours, theirs)
