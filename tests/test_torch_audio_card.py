"""The card's plan for ``utils/audio.mels_to_audio``: NNLS and Griffin-Lim
captured as CUDA graphs at a call shape's second call and replayed after,
against the eager ops on the card, at the real-time stream's shape (batch
1, 128 mels x 20 frames, ``n_fft`` 2048, hop 512, 32 iterations, a fixed
first phase) and at batch 3.

A replay runs the eager ops' kernels on the same inputs, so the waveforms
must equal the eager ones bit for bit: the eager ops as the public
functions run them (the basis, its NNLS constants and the window rebuilt
at each call) and the plan's own first, eager, call.

Each case skips without a card. This file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_audio_card.py
"""

import weakref

import numpy as np
import pytest
import torch

from decode_tonal_langauge_tpu_torch.ops import griffinlim as tgl
from decode_tonal_langauge_tpu_torch.ops import stft as tstft
from decode_tonal_langauge_tpu_torch.utils import audio

SR, N_MELS, N_FRAMES, N_FFT, HOP, N_ITER = 24414, 128, 20, 2048, 512, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    audio.release_plans()
    yield torch.device("cuda")
    audio.release_plans()


def _mels(batch, seed):
    """dB mels as the decoder gives them, flattened."""
    rng = np.random.default_rng(seed)
    return rng.normal(-40.0, 12.0, (batch, N_MELS * N_FRAMES)).astype(np.float32)


def _phase(seed, card):
    rng = np.random.default_rng(1000 + seed)
    phase = rng.uniform(-np.pi, np.pi, (1 + N_FFT // 2, N_FRAMES))
    return torch.as_tensor(phase, dtype=torch.float32, device=card)


def _eager(mels, phase, card):
    """The public functions' eager ops on the card."""
    mel = torch.tensor(mels.reshape(len(mels), N_MELS, -1), device=card)
    mel = tstft.db_to_power(mel, ref=0.0001)
    basis = torch.as_tensor(tstft.mel_filterbank(SR, N_FFT, N_MELS), dtype=torch.float32,
                            device=card)
    S_mag = tgl.mel_to_stft_mag(mel, basis)
    return tgl.griffinlim(S_mag, n_fft=N_FFT, hop_length=HOP, n_iter=N_ITER,
                          init_phase=phase).cpu().numpy()


def _call(mels, phase, **kw):
    return audio.mels_to_audio(mels, N_MELS, SR, n_fft=N_FFT, hop_length=HOP, n_iter=N_ITER,
                               init_phase=phase, device="cuda", **kw)


def _counts():
    return audio.EAGER_CALLS, audio.GRAPH_CAPTURES, audio.GRAPH_REPLAYS


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_replay_equals_the_eager_ops_bit_for_bit(card, batch):
    mels, phase = _mels(batch, batch), _phase(batch, card)
    want = _eager(mels, phase, card)
    assert want.shape == (batch, HOP * (N_FRAMES - 1)) and np.isfinite(want).all()
    for _ in range(4):  # eager, capture and replay, replay, replay
        np.testing.assert_array_equal(_call(mels, phase), want)


@pytest.mark.cuda
def test_replays_read_their_own_inputs(card):
    inputs = [(_mels(1, s), _phase(s, card)) for s in (1, 2)]
    wants = [_eager(m, p, card) for m, p in inputs]
    assert not np.array_equal(*wants)
    for m, p in inputs:  # eager, then capture and replay
        _call(m, p)
    for _ in range(2):
        for (m, p), want in zip(inputs, wants):
            np.testing.assert_array_equal(_call(m, p), want)
    # mels with another phase, and the phase drawn from a seed, as the
    # eager path draws it
    m, p = inputs[0][0], inputs[1][1]
    np.testing.assert_array_equal(_call(m, p), _eager(m, p, card))
    drawn = tgl.random_phase((1 + N_FFT // 2, N_FRAMES), seed=5).to(card)
    np.testing.assert_array_equal(_call(m, None, seed=5), _eager(m, drawn, card))
    assert audio.GRAPH_CAPTURES and len(audio._PLANS) == 1


@pytest.mark.cuda
def test_counters_read_eager_capture_replay(card):
    mels, phase = _mels(1, 7), _phase(7, card)
    before, steps = _counts(), []
    for _ in range(3):
        _call(mels, phase)
        steps.append(tuple(a - b for a, b in zip(_counts(), before)))
    assert steps == [(1, 0, 0), (1, 1, 1), (1, 1, 2)]


@pytest.mark.cuda
def test_eviction_frees_the_oldest_plan(card):
    phase = _phase(0, card)
    _call(_mels(1, 0), phase)
    _call(_mels(1, 0), phase)
    oldest = next(iter(audio._PLANS.values()))
    graphs, wave = oldest.graphs[:2], weakref.ref(oldest.graphs.wave)
    assert all(id(g) in audio._GRAPHS for g in graphs)
    for batch in range(2, 2 + audio.PLAN_SLOTS):  # PLAN_SLOTS newer shapes
        _call(_mels(batch, batch), phase)
    assert oldest.key not in audio._PLANS and len(audio._PLANS) == audio.PLAN_SLOTS
    assert oldest.graphs is None and wave() is None
    assert not any(id(g) in audio._GRAPHS for g in graphs)
    before = _counts()
    _call(_mels(1, 0), phase)  # the evicted shape starts again, eagerly
    assert _counts()[0] == before[0] + 1
