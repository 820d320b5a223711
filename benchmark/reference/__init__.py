"""The plain reference the benchmark judges the port against.

Plain PyTorch, written from the models' equations, one file per
architecture (``cnn.py``, ``cnnrnn.py``, ``synthesis_cnn.py``) plus the
loss and NAdam (``train.py``), the decode path (``decode.py``) and the
audio inverse (``audio.py``). It imports neither JAX, nor the JAX
package, nor anything of the port, and takes nothing the port has made:
the harness hands it the same seeded inputs and weights it hands the
port, and it works out again what the port derives from them (dropout
masks, label dynamics, mels, waveforms).

Every function computes in the precision it is given
(``precision.Precision``): float64 for the reference itself, float32
with TF32 off, or float32 with every product's operands rounded to TF32
first, the control that a correct comparison must reject.
"""
