"""The plain reference the benchmark judges the port against.

Plain PyTorch, written from the models' equations, one file per
architecture (``cnn.py``, ``cnnrnn.py``, ``synthesis_cnn.py``) plus the
loss and NAdam (``train.py``), the decode path (``decode.py``) and the
audio inverse (``audio.py``). It imports neither JAX, nor the JAX
package, nor anything of the port, and takes nothing the port has made:
the harness hands it the same seeded inputs and weights it hands the
port, and it works out again what the port derives from them (dropout
masks, label dynamics, mels, waveforms).

A configuration's model entry names its architecture's file under
``"reference"`` (:func:`module_of`), so a new architecture is a new file
here and no file names it. Such a file gives ``param_spec(m)`` (the
tensors in the port's state-dict names, with their init), ``forward(p,
*inputs, m, prec, masks=None)`` and ``dropout_shapes(m, batch)`` (each
dropout's input shape, in forward order; empty without dropout), and
where a fit starts a bias at its train mels' mean, that tensor's name as
``MEAN_MEL_BIAS``.

Every function computes in the precision it is given
(``precision.Precision``): float64 for the reference itself, float32
with TF32 off, or float32 with every product's operands rounded to TF32
first, the control that a correct comparison must reject.
"""

import importlib
from types import ModuleType
from typing import Dict


def module_of(m: Dict) -> ModuleType:
    """The reference module of model entry ``m``: ``<m["reference"]>.py``
    in this folder."""
    name = m["reference"]
    if not name.isidentifier():
        raise ValueError(f"a model entry's reference {name!r} is not a module name")
    return importlib.import_module(f"{__name__}.{name}")
