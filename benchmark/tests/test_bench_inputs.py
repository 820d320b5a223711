"""The cells' inputs and weights, held fixed.

A cell's digest is taken at a pinned seed, at ``tiny.py``'s small sizes
on the CPU, over every value that the harness's seeded draws hand the
cell's set-up, in call order: each public function of
``harness/inputs.py`` and ``harness/weights.py`` (trials, splits, seeds
for the port's generators, scalers, mels, recordings, weights) and of
``harness/program.py`` but the three that build the port's objects (the
weights as the port is given them, scalers, the mapping, Griffin-Lim's
first phase). The four cells the benchmark began with were recorded
from the harness as it stood before architectures were found by file,
and ``cnnrnn_fit.s1_b16`` from the harness that added it. A digest that
moves means a cell's inputs or weights moved, which its bounds and
limits no longer describe. The digests are of this CPU build of torch
and numpy, with one torch thread."""

import functools
import hashlib
import inspect
import sys

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import cells, inputs, program, weights
from tiny import config, mix

SEED = 2**31 + 2024
PORT_BUILDERS = ("build", "frozen", "decoder")
RECORDED = {
    "synthfull_fit.s4_b8": "2327ca52a2f8be954816cb528a6cbfd3bb0d58f82bb6e53445fbd02e8498428a",
    "cnnrnn_fit.s4_b32": "f67bd94dda5c95ab6c8dab425dad83e47e396d4cfd6cb9135ab38ccbc3f4e55e",
    "synthfull_stream.realtime": "5b47c6a83e9dd004f2d95449087ca97839327b82261b865fdcbcd3a4174512de",
    "synthfull_decode.offline": "0601bab9f227b29613a5c59384e9937c1acecdacb35b235a4585c0e20f113bb9",
    "cnnrnn_fit.s1_b16": "7ab43f6768d66ea0ddef961f68b71fbc5ed47c19c44440c0aa05572de8ea693e",
}


def _feed(h, value) -> None:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous().numpy()
    if isinstance(value, np.ndarray):
        h.update(f"{value.dtype}{value.shape}".encode())
        h.update(np.ascontiguousarray(value).tobytes())
    elif isinstance(value, dict):
        for k in sorted(value, key=str):
            h.update(repr(k).encode())
            _feed(h, value[k])
    elif isinstance(value, (list, tuple)):
        h.update(f"{type(value).__name__}{len(value)}".encode())
        for v in value:
            _feed(h, v)
    elif isinstance(value, np.random.Generator):
        _feed(h, value.bit_generator.state)
    else:
        h.update(repr(value).encode())


def digest(name: str) -> str:
    """The digest of cell ``name``'s set-up at ``SEED``."""
    bench = cells.benchmark()
    cell = cells.cell(name, bench)
    cfg, m = config(cell["config"]), mix(cell["traffic"])
    h = hashlib.sha256()
    patched = []
    for module, skip in ((inputs, ()), (weights, ()), (program, PORT_BUILDERS)):
        for fname, fn in inspect.getmembers(module, inspect.isfunction):
            if fn.__module__ != module.__name__ or fname.startswith("_") or fname in skip:
                continue

            @functools.wraps(fn)
            def recorded(*args, _fn=fn, _name=fname, **kwargs):
                out = _fn(*args, **kwargs)
                h.update(_name.encode())
                _feed(h, out)
                return out

            patched.append((module, fname, fn))
            setattr(module, fname, recorded)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = run.Context(name, cfg, m, SEED, torch.device("cpu"), sys.stderr)
        ctx.seconds = 0.5
        cells.module("traffic", m["driver"]).setup(ctx)
    finally:
        torch.set_num_threads(threads)
        for module, fname, fn in patched:
            setattr(module, fname, fn)
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_a_cells_inputs_and_weights_are_as_recorded(name):
    assert digest(name) == RECORDED[name]


def test_every_cell_is_recorded():
    assert {w["name"] for w in cells.benchmark()["workloads"]} == set(RECORDED)
