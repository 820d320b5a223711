"""PyTorch / CUDA port of the tonal-language decoding framework.

A second package beside ``decode_tonal_langauge_tpu`` (the JAX
reference). It imports ``torch``, numpy and scipy only, never JAX or the
JAX package, and keeps its own copies of the host helpers it needs.

It covers the preprocess stage (``preprocess/``):

    raw block (C, T) at the recording rate
      -> polyphase / FFT downsample (``ops/resample.py``)
      -> Gaussian-bank Hilbert envelope, Butterworth and FIR bands
         (``ops/hilbert.py``, ``ops/iir.py``, ``ops/fir.py``)
      -> CAR / interval / channel / rolling z-score (``ops/rereference.py``)
      -> per-block npz files

classifier training (``training/``):

    sample npz + channel selection
      -> per-target CNN / CNN-RNN / logistic fits (NAdam, early stopping,
         the LSTM's hand-written backward in ``ops/lstm.py``), one per seed
      -> results.csv, per-seed histories, torch checkpoints

channel selection (``channel_selection/``, ``ops/anova.py``):

    sample npz
      -> event-vs-rest and label-grouped ANOVA at every (channel, time)
      -> Bonferroni + run-length filter -> per-subject channel JSON

the evaluation and visualisation stages (``evaluation/``,
``visualisation/``), the YAML pipeline runner that drives every stage
from one config (``pipeline.py``; ``python -m
decode_tonal_langauge_tpu_torch <config.yaml> [--device cpu]``),
and the serving path:

    epochs (B, C, T)
      -> tone (CNN-RNN) + syllable (CNN) classifier probabilities
      -> predicted label dynamics (table gather)
      -> synthesizer mel spectrograms
      -> NNLS + Griffin-Lim waveforms

(``serving.py``), plus ``ops/iir.py`` whose long, stateful, high-order
route runs the hand-written sm_90a DF2T kernel, a time-chunked
three-pass scan (``csrc/iir_df2t.cu``, bound in ``ops/cuda_iir.py``).

Entry points take ``device=None``, which means CUDA; they raise when no
card is present and run on the CPU only when asked (``device="cpu"``).
"""

__version__ = "0.1.0"
