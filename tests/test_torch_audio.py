"""The port's audio stack (``ops/stft.py``, ``ops/griffinlim.py``,
``utils/audio.py``) against the JAX package on the same numpy inputs.

Griffin-Lim draws its first phase with ``jax.random`` on the JAX side;
the port takes it as ``init_phase``, so the tests hand the JAX draw to
both. Tolerances are stated per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu.ops import griffinlim as jgl
from decode_tonal_langauge_tpu.ops import stft as jstft
from decode_tonal_langauge_tpu.utils import audio as jaudio
from decode_tonal_langauge_tpu_torch.ops import griffinlim as tgl
from decode_tonal_langauge_tpu_torch.ops import stft as tstft
from decode_tonal_langauge_tpu_torch.utils import audio as taudio

SR = 8000
MEL_KW = dict(n_fft=512, hop_length=128, n_mels=32)


def _harmonic(scale=1.0, sr=SR, n=4096, f0=220.0):
    t = np.arange(n) / sr
    return (scale * (np.sin(2 * np.pi * f0 * t)
                     + 0.5 * np.sin(2 * np.pi * 2 * f0 * t))).astype(np.float32)


def _jax_phase(n_freq, n_frames):
    """The first phase JAX's griffinlim draws (key 0)."""
    return np.array(jax.random.uniform(
        jax.random.key(0), (n_freq, n_frames), minval=-jnp.pi, maxval=jnp.pi,
        dtype=jnp.float32))


def test_stft_matches_jax(rng):
    y = rng.standard_normal(2000).astype(np.float32)
    ours = tstft.stft(torch.from_numpy(y), 256, 64).numpy()
    theirs = np.asarray(jstft.stft(y, 256, 64))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3)  # test_audio.py:39
    np.testing.assert_allclose(
        tstft.stft_magsq(torch.from_numpy(y), 256, 64).numpy(),
        np.asarray(jstft.stft_magsq(y, 256, 64)), rtol=1e-3, atol=1e-3,
    )


@pytest.mark.parametrize("length", [4096, 4000, None])
def test_istft_matches_jax(rng, length):
    X = np.array(jstft.stft(rng.standard_normal(4096).astype(np.float32), 512, 128))
    ours = tstft.istft(torch.from_numpy(X), 512, 128, length=length).numpy()
    theirs = np.asarray(jstft.istft(X, 512, 128, length=length))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3)  # test_audio.py:46


def test_batched_stft_matches_per_signal(rng):
    y = rng.standard_normal((3, 1500)).astype(np.float32)
    batched = tstft.stft(torch.from_numpy(y), 256, 64)
    for i in range(3):
        assert torch.equal(batched[i], tstft.stft(torch.from_numpy(y[i]), 256, 64))


def test_mel_filterbank_is_the_same_host_math():
    np.testing.assert_array_equal(
        tstft.mel_filterbank(24414, 2048, 128), jstft.mel_filterbank(24414, 2048, 128)
    )
    f = np.array([55.0, 440.0, 1000.0, 7999.0])
    np.testing.assert_array_equal(tstft.hz_to_mel(f), jstft.hz_to_mel(f))
    np.testing.assert_array_equal(tstft.mel_to_hz(f / 100), jstft.mel_to_hz(f / 100))
    np.testing.assert_array_equal(tstft.hann_window(64), jstft.hann_window(64))


@pytest.mark.parametrize("ref,top_db", [(None, 80.0), (1.0, None)])
def test_db_conversions_match_jax(rng, ref, top_db):
    S = rng.random((10, 20)).astype(np.float32) + 1e-6
    ours = tstft.power_to_db(torch.from_numpy(S), ref=ref, top_db=top_db).numpy()
    theirs = np.array(jstft.power_to_db(S, ref=ref, top_db=top_db))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tstft.db_to_power(torch.from_numpy(theirs), ref=1e-4).numpy(),
        np.asarray(jstft.db_to_power(theirs, ref=1e-4)), rtol=1e-5,
    )


def test_nnls_matches_jax(rng):
    A = np.abs(rng.random((30, 10))).astype(np.float32)
    B = A @ np.abs(rng.random((10, 7))).astype(np.float32)
    ours = tgl.nnls_project(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    theirs = np.asarray(jgl.nnls_project(A, B))
    assert (ours >= 0).all()
    # Same 100 accelerated steps in f32; the pseudo-inverse start comes
    # from two SVD implementations, so allow a few f32 ulps of drift.
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_griffinlim_matches_jax_given_its_phase():
    y = _harmonic()
    S_mag = np.abs(np.asarray(jstft.stft(y, 512, 128)))
    theirs = np.asarray(jgl.griffinlim(S_mag, n_fft=512, hop_length=128,
                                       n_iter=16, length=len(y)))
    ours = tgl.griffinlim(
        torch.from_numpy(S_mag), n_fft=512, hop_length=128, n_iter=16,
        length=len(y), init_phase=torch.from_numpy(_jax_phase(*S_mag.shape)),
    ).numpy()
    # the tolerance of tests/test_audio.py:160 (batched vs per-trial GL)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_audio_to_mel_matches_jax():
    y = _harmonic()
    ours = taudio.audio_to_mel(y, SR, mel_kwargs=MEL_KW, device="cpu")
    theirs = jaudio.audio_to_mel(y, SR, mel_kwargs=MEL_KW)
    assert ours.shape == theirs.shape
    # dB of f32 powers: 1e-3 relative power error is ~4e-3 dB
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_iter", [8, 32])
def test_mels_to_audio_matches_jax(n_iter):
    mels = np.stack([jaudio.audio_to_mel(_harmonic(1.0 + 0.2 * i), SR,
                                         mel_kwargs=MEL_KW) for i in range(3)])
    theirs = jaudio.mels_to_audio(mels, n_mels=32, audio_sampling_rate=SR,
                                  n_fft=512, hop_length=128, n_iter=n_iter)
    phase = _jax_phase(257, mels.shape[1] // 32)
    ours = taudio.mels_to_audio(
        mels, n_mels=32, audio_sampling_rate=SR, n_fft=512, hop_length=128,
        n_iter=n_iter, init_phase=torch.from_numpy(phase), device="cpu",
    )
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)  # test_audio.py:160
    single = taudio.mel_to_audio(
        mels[1], n_mels=32, audio_sampling_rate=SR, n_fft=512, hop_length=128,
        n_iter=n_iter, init_phase=torch.from_numpy(phase), device="cpu",
    )
    np.testing.assert_allclose(single, ours[1], rtol=1e-4, atol=1e-5)


def test_default_phase_is_seeded_and_shared():
    mels = np.stack([jaudio.audio_to_mel(_harmonic(1.0 + 0.2 * i), SR,
                                         mel_kwargs=MEL_KW) for i in range(2)])
    kw = dict(n_mels=32, audio_sampling_rate=SR, n_fft=512, hop_length=128,
              n_iter=4, device="cpu")
    a = taudio.mels_to_audio(mels, **kw)
    np.testing.assert_array_equal(a, taudio.mels_to_audio(mels, **kw))
    phase = tgl.random_phase((257, mels.shape[1] // 32), seed=0)
    np.testing.assert_array_equal(
        a, taudio.mels_to_audio(mels, init_phase=phase, **kw))


def test_mels_to_audio_rejects_1d(rng):
    with pytest.raises(ValueError, match="batch"):
        taudio.mels_to_audio(rng.random(64), n_mels=8, device="cpu")


def test_write_wav(tmp_path):
    taudio.write_wav(str(tmp_path / "t.wav"), _harmonic(), SR)
    from scipy.io import wavfile

    sr, data = wavfile.read(tmp_path / "t.wav")
    assert sr == SR and len(data) == 4096 and data.dtype == np.int16


# ----------------------------------------------------------------------
# The card's plan for mels_to_audio builds the mel basis, its NNLS
# constants, the Hann window and the NOLA sum once and runs the solve and
# Griffin-Lim over them. Here, on the CPU, those ops against the formulas
# the port ran before it had the plan (copied below), bit for bit.

def _before_window(n_fft, like):
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return torch.as_tensor(tstft.hann_window(n_fft), dtype=dtype, device=like.device)


def _before_stft(y, n_fft, hop_length):
    y = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2))
    frames = y.unfold(-1, n_fft, hop_length) * _before_window(n_fft, y)
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


def _before_istft(X, n_fft, hop_length, length=None):
    window = _before_window(n_fft, X)
    frames = torch.fft.irfft(X.transpose(-1, -2), n=n_fft, dim=-1) * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    total = n_fft + hop_length * (n_frames - 1)

    def overlap_add(f):
        out = torch.nn.functional.fold(f.transpose(1, 2), output_size=(1, total),
                                       kernel_size=(1, n_fft), stride=(1, hop_length))
        return out.reshape(f.shape[0], total)

    y = overlap_add(frames.reshape(-1, n_frames, n_fft)).reshape(lead + (total,))
    wsum = overlap_add((window ** 2).expand(1, n_frames, n_fft))[0]
    y = y / torch.clamp(wsum, min=1e-10)
    y = y[..., n_fft // 2 : total - n_fft // 2]
    if length is not None:
        if y.shape[-1] < length:
            y = torch.nn.functional.pad(y, (0, length - y.shape[-1]))
        y = y[..., :length]
    return y


def _before_nnls_project(A, B, n_iter=100):
    AtA = A.T @ A
    AtB = A.T @ B
    v = torch.ones(AtA.shape[0], dtype=A.dtype, device=A.device)
    v = v / np.sqrt(AtA.shape[0])
    for _ in range(30):
        v = AtA @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
    step = 1.0 / torch.clamp(v @ (AtA @ v), min=1e-12)
    rtol = 10.0 * max(A.shape) * torch.finfo(A.dtype).eps
    X = torch.clamp(torch.linalg.pinv(A, rtol=rtol) @ B, min=0.0)
    Y = X
    t = np.float32(1.0)
    for _ in range(n_iter):
        X_new = torch.clamp(Y - step * (AtA @ Y - AtB), min=0.0)
        t_new = np.float32(0.5) * (
            np.float32(1.0) + np.sqrt(np.float32(1.0) + np.float32(4.0) * t * t))
        Y = X_new + float((t - 1.0) / t_new) * (X_new - X)
        X, t = X_new, t_new
    return X


def _before_griffinlim(S_mag, n_fft, hop_length, n_iter, init_phase, length=None,
                       momentum=0.99):
    angles = torch.exp(1j * init_phase.to(device=S_mag.device, dtype=torch.float32))
    S = S_mag.to(torch.complex64)
    angles = angles.expand(S.shape)
    tprev = torch.zeros_like(S)
    for _ in range(n_iter):
        rebuilt = _before_stft(_before_istft(S * angles, n_fft, hop_length), n_fft, hop_length)
        new_angles = rebuilt - (momentum / (1.0 + momentum)) * tprev
        angles = new_angles / torch.clamp(new_angles.abs(), min=1e-16)
        tprev = rebuilt
    return _before_istft(S * angles, n_fft, hop_length, length=length)


def _before_mels_to_audio(mels, n_mels, sr, n_fft, hop_length, n_iter, init_phase,
                          mel_in_db=True, power=2.0, length=None):
    mel = torch.tensor(mels.reshape(mels.shape[0], n_mels, -1))
    if mel_in_db:
        mel = tstft.db_to_power(mel, ref=0.0001)
    basis = torch.as_tensor(tstft.mel_filterbank(sr, n_fft, n_mels), dtype=torch.float32)
    S_mag = torch.pow(torch.clamp(_before_nnls_project(basis, mel), min=0.0), 1.0 / power)
    return _before_griffinlim(S_mag, n_fft, hop_length, n_iter, init_phase,
                              length=length).numpy()


def _mels(n=2):
    return np.stack([jaudio.audio_to_mel(_harmonic(1.0 + 0.2 * i), SR, mel_kwargs=MEL_KW)
                     for i in range(n)])


def _constants_cpu_key():
    return (torch.device("cpu"), float(SR), 512, 32, 0.0, None)


def _constants_cpu():
    return taudio.constants(*_constants_cpu_key())


@pytest.mark.parametrize("length", [None, 4000, 4200])
def test_stft_and_istft_keep_their_bits(rng, length):
    y = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    X = tstft.stft(y, 512, 128)
    assert torch.equal(X, _before_stft(y, 512, 128))
    assert torch.equal(tstft.istft(X, 512, 128, length=length),
                       _before_istft(X, 512, 128, length=length))
    window = tstft.hann(512)
    wsum = tstft.nola_sum(window, 128, X.shape[-1])
    assert torch.equal(tstft.windowed_istft(X, window, wsum, 128, length),
                       _before_istft(X, 512, 128, length=length))


def test_nnls_over_cached_constants_keeps_its_bits():
    c = _constants_cpu()
    basis = torch.as_tensor(tstft.mel_filterbank(SR, 512, 32), dtype=torch.float32)
    assert torch.equal(c.basis, basis)
    assert torch.equal(c.window, _before_window(512, basis))
    mel = tstft.db_to_power(torch.from_numpy(_mels().reshape(2, 32, -1)), ref=0.0001)
    before = _before_nnls_project(basis, mel)
    assert torch.equal(tgl.nnls_project(basis, mel), before)
    assert torch.equal(tgl.nnls_solve(c.basis, mel, c.nnls), before)
    assert _constants_cpu() is c  # built once


@pytest.mark.parametrize("length", [None, 4096])
def test_griffinlim_over_cached_window_keeps_its_bits(length):
    S_mag = tstft.stft(torch.from_numpy(np.stack([_harmonic(), _harmonic(0.5)])),
                       512, 128).abs()
    phase = torch.from_numpy(_jax_phase(*S_mag.shape[-2:]))
    before = _before_griffinlim(S_mag, 512, 128, 8, phase, length=length)
    assert torch.equal(tgl.griffinlim(S_mag, n_fft=512, hop_length=128, n_iter=8,
                                      length=length, init_phase=phase), before)
    c = _constants_cpu()
    wsum = tstft.nola_sum(c.window, 128, S_mag.shape[-1])
    assert torch.equal(tgl.griffinlim_windowed(S_mag, phase, c.window, wsum, 128, 8,
                                               length=length), before)


@pytest.mark.parametrize("mel_in_db,power", [(True, 2.0), (False, 1.0)])
def test_mels_to_audio_and_the_plan_body_keep_their_bits(mel_in_db, power):
    mels = _mels(3)
    if not mel_in_db:
        mels = np.abs(mels) / 80.0
    phase = torch.from_numpy(_jax_phase(257, mels.shape[1] // 32))
    kw = dict(n_fft=512, hop_length=128, n_iter=8, mel_in_db=mel_in_db, power=power)
    before = _before_mels_to_audio(mels, 32, SR, init_phase=phase, **kw)
    ours = taudio.mels_to_audio(mels, n_mels=32, audio_sampling_rate=SR, init_phase=phase,
                                device="cpu", **kw)
    np.testing.assert_array_equal(ours, before)
    # the card's eager call and its graphs run these ops, in this order
    key = taudio.plan_key("cpu", (3, 32, mels.shape[1] // 32), SR, mel_in_db, 512, 128, 0.0,
                          None, power, 8, None, phase.shape)
    c = taudio.constants(*key.constants)
    S_mag = taudio._nnls(key, c, torch.from_numpy(mels.reshape(3, 32, -1)))
    wsum = tstft.nola_sum(c.window, 128, key.shape[-1])
    np.testing.assert_array_equal(taudio._griffinlim(key, c, wsum, S_mag, phase).numpy(),
                                  before)


def test_mels_to_audio_on_the_cpu_never_captures():
    mels = _mels(1)
    kw = dict(n_mels=32, audio_sampling_rate=SR, n_fft=512, hop_length=128, n_iter=2,
              device="cpu")
    counts = (taudio.EAGER_CALLS, taudio.GRAPH_CAPTURES, taudio.GRAPH_REPLAYS)
    for _ in range(3):
        taudio.mels_to_audio(mels, **kw)
    assert (taudio.EAGER_CALLS, taudio.GRAPH_CAPTURES, taudio.GRAPH_REPLAYS) == (
        counts[0] + 3, counts[1], counts[2])
    assert not taudio._PLANS and not taudio._GRAPHS


_KEY_BASE = dict(device="cpu", shape=(1, 128, 20), audio_sampling_rate=24414, mel_in_db=True,
                 n_fft=2048, hop_length=512, fmin=0.0, fmax=None, power=2.0, n_iter=32,
                 length=None, phase_shape=(1025, 20))


@pytest.mark.parametrize("change,of_constants", [
    (dict(device="cuda"), True),
    (dict(shape=(3, 128, 20)), False),
    (dict(shape=(1, 64, 40), phase_shape=(1025, 40)), True),
    (dict(shape=(1, 128, 21)), False),
    (dict(audio_sampling_rate=16000), True),
    (dict(mel_in_db=False), False),
    (dict(n_fft=1024), True),
    (dict(hop_length=256), False),
    (dict(fmin=50.0), True),
    (dict(fmax=8000.0), True),
    (dict(power=1.0), False),
    (dict(n_iter=16), False),
    (dict(length=9728), False),
    (dict(phase_shape=(1, 1025, 20)), False),
])
def test_plan_key_separates_every_keyed_parameter(change, of_constants):
    base = taudio.plan_key(**_KEY_BASE)
    other = taudio.plan_key(**dict(_KEY_BASE, **change))
    assert other != base and hash(other) != hash(base)
    assert (other.constants != base.constants) == of_constants
    assert taudio.plan_key(**_KEY_BASE) == base
    # an int rate and its float, or a numpy shape, are the same call
    assert taudio.plan_key(**dict(_KEY_BASE, audio_sampling_rate=24414.0,
                                  shape=np.array([1, 128, 20]))) == base
