"""The port's signal ops (``decode_tonal_langauge_tpu_torch/ops/``:
``resample``, ``hilbert``, ``fir``, ``rereference``, ``framing``)
against the JAX package's and their SciPy/pandas oracles.

Inputs come from a seeded numpy generator and go through both packages
on the CPU. Each tolerance is the one of the JAX op's oracle test in
``tests/test_ops_signal.py``, named in the test's docstring.
"""

from fractions import Fraction

import numpy as np
import pandas as pd
import pytest
import scipy.signal as sps
import torch

from decode_tonal_langauge_tpu.ops import fir as jfir
from decode_tonal_langauge_tpu.ops import framing as jframing
from decode_tonal_langauge_tpu.ops import hilbert as jhilbert
from decode_tonal_langauge_tpu.ops import rereference as jreref
from decode_tonal_langauge_tpu.ops import resample as jresample
from decode_tonal_langauge_tpu_torch.ops import fir as tfir
from decode_tonal_langauge_tpu_torch.ops import framing as tframing
from decode_tonal_langauge_tpu_torch.ops import hilbert as thilbert
from decode_tonal_langauge_tpu_torch.ops import rereference as treref
from decode_tonal_langauge_tpu_torch.ops import resample as tresample

TDT_SF = 3051.7578125


def _sig(c, t, seed=0):
    return np.random.default_rng(seed).standard_normal((c, t)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=atol)


class TestResample:
    @pytest.mark.parametrize("num", [500, 512, 1999, 2000, 2501, 4000])
    def test_fft_resample(self, num):
        """rtol/atol 2e-4 (``TestResample::test_matches_scipy``)."""
        x = _sig(3, 2000)
        ours = tresample.fft_resample(_t(x), num)
        assert ours.dtype == torch.float32 and ours.shape == (3, num)
        _close(ours, jresample.fft_resample(x, num), 2e-4, 2e-4)
        _close(ours, sps.resample(x.astype(np.float64), num, axis=-1), 2e-4, 2e-4)

    @pytest.mark.parametrize("up,down", [(100, 763), (2, 3), (3, 1), (5, 7), (1, 4)])
    def test_polyphase_conv_route(self, up, down):
        """rtol 1e-4, atol 1e-5 (``test_polyphase_matches_scipy``)."""
        x = _sig(3, 2289)
        ours = tresample.polyphase_resample(_t(x), up, down)
        ref = sps.resample_poly(x.astype(np.float64), up, down, axis=-1)
        assert ours.shape == ref.shape
        _close(ours, jresample.polyphase_resample(x, up, down), 1e-4, 1e-5)
        _close(ours, ref, 1e-4, 1e-5)

    def test_host_tables_equal_jax(self):
        """The filter design and both tap tables are host numpy copies of
        the JAX package's: exactly equal."""
        for up, down in ((4, 9), (100, 763)):
            np.testing.assert_array_equal(
                tresample.resample_poly_filter(up, down),
                jresample.resample_poly_filter(up, down),
            )
            w, pad = tresample._polyphase_tables(up, down)
            jw, jpad = jresample._polyphase_tables(up, down)
            np.testing.assert_array_equal(w, jw)
            assert pad == jpad
        fr = (Fraction(400) / Fraction(TDT_SF)).limit_denominator(10_000)
        h, d = tresample._phase_tap_table(fr.numerator, fr.denominator)
        jh, jd = jresample._phase_tap_table(fr.numerator, fr.denominator)
        np.testing.assert_array_equal(h, jh)
        assert d == jd

    def test_gather_route_at_tdt_rate(self, monkeypatch):
        """3051.7578125 Hz reduces to 1109 phases (the gather route);
        rtol 1e-4, atol 1e-5 (``test_gather_path_for_odd_rational_rates``).
        A small slice bound makes the port walk several output slices."""
        monkeypatch.setattr(tresample, "_GATHER_ELEMENTS", 2 * 153 * 1000)
        x = _sig(2, 30518)
        ours = tresample.resample_to_rate(_t(x), TDT_SF, 400.0)
        fr = (Fraction(400) / Fraction(TDT_SF)).limit_denominator(10000)
        assert fr.numerator > tresample._CONV_PHASE_LIMIT
        ref = sps.resample_poly(x.astype(np.float64), fr.numerator, fr.denominator, axis=-1)
        n = min(ours.shape[-1], ref.shape[-1])
        _close(ours[:, :n], ref[:, :n], 1e-4, 1e-5)
        _close(ours, jresample.resample_to_rate(x, TDT_SF, 400.0), 1e-4, 1e-5)

    def test_tail_is_computed_not_zero(self):
        """The edge-padded tail at a prime length (``test_rate_tail_is_computed_not_zero``:
        within 0.05 of 1 for a constant signal), and equal to JAX's within
        rtol 1e-4, atol 1e-5."""
        t = 10007
        x = np.ones((2, t), dtype=np.float32)
        ours = tresample.resample_to_rate(_t(x), TDT_SF, 400.0, method="poly")
        assert ours.shape[-1] == int(t * 400.0 / TDT_SF)
        assert abs(float(ours[:, -1].mean()) - 1.0) < 0.05
        _close(ours, jresample.resample_to_rate(x, TDT_SF, 400.0, method="poly"), 1e-4, 1e-5)

    @pytest.mark.parametrize("t", [3052, 30520])
    def test_auto_route(self, t):
        """Up to ``FFT_LENGTH_LIMIT`` samples the FFT method, above it the
        polyphase conv; the int() length rule either way. rtol 1e-4, atol
        1e-5 against JAX (``test_rate_helper_poly_long_signal``) and
        2e-4 on the FFT route (``test_matches_scipy``)."""
        x = _sig(2, t)
        ours = tresample.resample_to_rate(_t(x), 3052.0, 400.0)
        assert ours.shape == (2, int(t * (400 / 3052)))
        tol = (1e-4, 1e-5) if t > tresample.FFT_LENGTH_LIMIT else (2e-4, 2e-4)
        _close(ours, jresample.resample_to_rate(x, 3052.0, 400.0), *tol)
        if t > tresample.FFT_LENGTH_LIMIT:
            ref = sps.resample_poly(x.astype(np.float64), 100, 763, axis=-1)
            _close(ours, ref[:, : ours.shape[-1]], 1e-4, 1e-5)

    def test_unknown_method_raises(self):
        with pytest.raises(ValueError, match="fft/poly/auto"):
            tresample.resample_to_rate(_t(_sig(1, 100)), 1000.0, 400.0, method="x")


class TestHilbert:
    @pytest.mark.parametrize(
        "ranges", [[(70.0, 150.0)], (70.0, 150.0), [70, 110], [(4.0, 8.0), (70.0, 150.0)]]
    )
    def test_bank_params_and_kernels_equal_jax(self, ranges):
        """Host numpy copies: exactly equal."""
        c, s = thilbert.gaussian_bank_params(ranges)
        jc, js = jhilbert.gaussian_bank_params(ranges)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(s, js)
        for n in (1024, 1025):
            np.testing.assert_array_equal(
                thilbert.bank_kernels(n, 400.0, c, s), jhilbert.bank_kernels(n, 400.0, jc, js)
            )

    @pytest.mark.parametrize("envelope", [True, False])
    def test_hilbert_filter(self, envelope):
        """rtol 5e-3, atol 5e-4 (``TestHilbert::test_matches_numpy_oracle``)."""
        x = _sig(3, 1024)
        ours = thilbert.hilbert_filter(_t(x), 400.0, [(70.0, 150.0)], envelope=envelope)
        ref = jhilbert.hilbert_filter(x, 400.0, [(70.0, 150.0)], envelope=envelope)
        assert ours.dtype == torch.float32
        _close(ours, ref, 5e-3, 5e-4)

    @pytest.mark.parametrize(
        "t,chunk,overlap,envelope",
        [(20000, 4096, 512, True), (20000, 4096, 512, False), (17000, 8192, 1024, True)],
    )
    def test_hilbert_filter_blocked(self, t, chunk, overlap, envelope):
        """Against JAX's blocked op at the same chunk and overlap, over
        every sample; rtol 5e-3, atol 5e-4 (the Hilbert oracle's)."""
        x = _sig(2, t)
        kw = dict(chunk=chunk, overlap=overlap, envelope=envelope)
        ours = thilbert.hilbert_filter_blocked(_t(x), 400.0, [(70.0, 150.0)], **kw)
        ref = jhilbert.hilbert_filter_blocked(x, 400.0, [(70.0, 150.0)], **kw)
        assert ours.shape == ref.shape == (2, t)
        _close(ours, ref, 5e-3, 5e-4)

    def test_empty_bank_raises(self):
        for fn in (thilbert.hilbert_filter, thilbert.hilbert_filter_blocked):
            with pytest.raises(ValueError, match="empty"):
                fn(_t(_sig(1, 256)), 400.0, [(0.001, 0.002)])


class TestFIR:
    def test_fir_causal(self):
        """rtol 1e-3, atol 1e-5 (``TestFIR::test_causal_fir_matches_lfilter``)."""
        taps = sps.firwin(91, [0.2, 0.3], pass_zero=False)
        x = _sig(3, 1000)
        ours = tfir.fir_causal(taps.astype(np.float32), _t(x))
        _close(ours, jfir.fir_causal(taps.astype(np.float32), x), 1e-3, 1e-5)
        _close(ours, sps.lfilter(taps, 1.0, x.astype(np.float64), axis=-1), 1e-3, 1e-5)

    def test_fir_bandpass_filter(self):
        """rtol 1e-3, atol 1e-5 (``test_bandpass_bank_matches_reference_loop``)."""
        x = _sig(2, 800)
        fs, order, centers = 400.0, 90, [80.0, 110.0]
        np.testing.assert_array_equal(
            tfir.firwin_bandpass(order, 72.0, 88.0, fs),
            jfir.firwin_bandpass(order, 72.0, 88.0, fs),
        )
        ours = tfir.fir_bandpass_filter(_t(x), fs, order, centers)
        _close(ours, jfir.fir_bandpass_filter(x, fs, order, centers), 1e-3, 1e-5)


class TestRereference:
    def test_car(self):
        """rtol/atol 1e-5 (``TestRereference::test_car``)."""
        x = _sig(6, 500)
        ours = treref.car_rereference(_t(x), exclude_channels=[1, 4])
        _close(ours, jreref.car_rereference(x, exclude_channels=[1, 4]), 1e-5, 1e-5)
        _close(treref.car_rereference(_t(x)), jreref.car_rereference(x), 1e-5, 1e-5)

    @pytest.mark.parametrize("bad", [[9], [-1]])
    def test_car_invalid_channel(self, bad):
        with pytest.raises(ValueError):
            treref.car_rereference(_t(_sig(4, 100)), exclude_channels=bad)
        with pytest.raises(ValueError):
            jreref.car_rereference(_sig(4, 100), exclude_channels=bad)

    def test_interval_zscore(self):
        """Population std; rtol/atol 1e-4 (``test_interval_zscore``)."""
        x = _sig(4, 1000) + 3.0
        ours = treref.interval_zscore(_t(x), 0, 250)
        _close(ours, jreref.interval_zscore(x, 0, 250), 1e-4, 1e-4)
        sd = x[:, :250].std(axis=1, keepdims=True)
        _close(ours, (x - x[:, :250].mean(axis=1, keepdims=True)) / sd, 1e-4, 1e-4)

    @pytest.mark.parametrize("fill_nans", [False, True])
    def test_channel_zscore(self, fill_nans):
        """Population std; rtol/atol 1e-4 (``test_channel_zscore``). A
        channel holding a NaN turns NaN, zero-filled with ``fill_nans``."""
        x = _sig(4, 1000)
        x[2, 5] = np.nan
        ours = treref.channel_zscore(_t(x), fill_nans=fill_nans).numpy()
        ref = np.asarray(jreref.channel_zscore(x, fill_nans=fill_nans))
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
        assert np.isnan(ours[2]).all() != fill_nans
        _close(np.nan_to_num(ours), np.nan_to_num(ref), 1e-4, 1e-4)

    @pytest.mark.parametrize("t,w", [(700, 50), (40, 50)])
    def test_rolling_zscore(self, t, w):
        """pandas semantics, NaN in column 0 on both sides; rtol/atol 2e-3
        (``test_rolling_zscore_matches_pandas``). ``t <= w`` takes the
        branch where the window never fills."""
        x = _sig(3, t)
        ours = treref.rolling_zscore(_t(x), w).numpy()
        ref = np.asarray(jreref.rolling_zscore(x, w))
        df = pd.DataFrame(x.T.astype(np.float64))
        roll = df.rolling(window=w, min_periods=1)
        pd_ref = ((df - roll.mean()) / roll.std()).T.to_numpy()
        assert np.isnan(ours[:, 0]).all() and np.isnan(ref[:, 0]).all()
        assert not np.isnan(ours[:, 1:]).any()
        _close(ours[:, 1:], ref[:, 1:], 2e-3, 2e-3)
        _close(ours[:, 1:], pd_ref[:, 1:], 2e-3, 2e-3)

    def test_rolling_zscore_fill_nans(self):
        x = _sig(2, 100)
        ours = treref.rolling_zscore(_t(x), 10, fill_nans=True).numpy()
        assert np.isfinite(ours).all()
        _close(ours, jreref.rolling_zscore(x, 10, fill_nans=True), 2e-3, 2e-3)
        with pytest.raises(ValueError):
            treref.rolling_zscore(_t(x), 1)


class TestFraming:
    def test_extract_epochs_1d(self):
        """A gather: exactly equal."""
        x = _sig(1, 500)[0]
        starts = np.array([0, 17, 250, 400], np.int32)
        ours = tframing.extract_epochs_1d(_t(x), _t(starts), 100)
        ref = jframing.extract_epochs_1d(x, starts, 100)
        assert ours.shape == (4, 100)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("rest", [(0, 1000, 200), (13, 950, 200), (5, 100, 200)])
    def test_tile_rest_windows(self, rest):
        ours = tframing.tile_rest_windows(*rest)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jframing.tile_rest_windows(*rest)))
