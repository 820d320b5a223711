"""The decode path judged window by window against the plain reference:
class probabilities, label ids, mels and (where given) waveforms.

- ``prob_gap``: the largest gap of a class probability;
- ``id_mismatch``: windows whose tone or syllable id differs from the
  reference's where the reference's top two lie more than ``margin``
  apart (an exact comparison: its limit is 0);
- ``mel_gap_db``: the largest gap of a mel value, in dB, over windows
  whose ids agree;
- ``wave_gap``: the largest L2 gap of a waveform over the reference's
  norm, over the same windows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..reference import audio
from ..reference.decode import decode
from ..reference.precision import BY_NAME, no_tf32
from . import inputs, program, weights
from .compare import top2_margin


def reference(cfg: Dict, seed: int, windows: np.ndarray, device, precision: str = "f64",
              phase: Optional[torch.Tensor] = None, batch: int = 64,
              sums: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """The reference's decode of ``windows`` (N, C, T) in blocks of
    ``batch``: probabilities, ids, mels and, with ``phase``, waveforms.
    ``sums`` are the checksums of the weights the port was given."""
    prec = BY_NAME[precision]
    w = program.decode_weights(cfg, seed, device)
    if sums is not None and {k: weights.checksums(v) for k, v in w.items()} != sums:
        raise RuntimeError("the seeded decode weights did not draw again alike")
    sc = {k: tuple(torch.as_tensor(a, device=device) for a in v)
          for k, v in program.scalers(cfg, seed).items()}
    table = torch.as_tensor(inputs.dynamics_table(program.mapping(cfg)), device=device)
    groups = inputs.channel_groups(cfg)
    mel = cfg["mel"]
    out = {k: [] for k in ("tone_probs", "syllable_probs", "mel", "wave")}
    with no_tf32(), torch.no_grad():
        for lo in range(0, len(windows), batch):
            x = torch.as_tensor(windows[lo:lo + batch], device=device)
            pt, ps, m = decode(w, cfg["models"], x, groups, sc, table, prec)
            out["tone_probs"].append(pt.cpu().numpy())
            out["syllable_probs"].append(ps.cpu().numpy())
            out["mel"].append(m.cpu().numpy())
            if phase is not None:
                out["wave"].append(audio.waveform(
                    m, mel["n_mels"], mel["sample_rate_hz"], mel["n_fft"], mel["hop_length"],
                    phase, prec, n_iter=mel["griffinlim_iterations"]).cpu().numpy())
    res = {k: np.concatenate(v) for k, v in out.items() if v}
    res["tone"] = res["tone_probs"].argmax(1)
    res["syllable"] = res["syllable_probs"].argmax(1)
    return res


def gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], margin: float) -> Dict[str, float]:
    """``prog`` and ``ref`` hold the same windows' rows, in order."""
    agree = np.ones(len(ref["tone"]), bool)
    mismatch = np.zeros(len(ref["tone"]), bool)
    prob_gap = 0.0
    for key in ("tone", "syllable"):
        prob_gap = max(prob_gap, float(np.abs(prog[f"{key}_probs"] - ref[f"{key}_probs"]).max()))
        differ = prog[key] != ref[key]
        agree &= ~differ
        mismatch |= differ & (top2_margin(ref[f"{key}_probs"]) > margin)
    out = {"prob_gap": prob_gap, "id_mismatch": float(mismatch.sum()),
           "mel_gap_db": float(np.abs(prog["mel"] - ref["mel"])[agree].max(initial=0.0))}
    if "wave" in ref:
        d = np.linalg.norm(prog["wave"] - ref["wave"], axis=1) / np.linalg.norm(ref["wave"], axis=1)
        out["wave_gap"] = float(d[agree].max(initial=0.0))
    return out
