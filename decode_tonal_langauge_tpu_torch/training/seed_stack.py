"""S seeded copies of one module, run as one batched computation.

The port's counterpart of the JAX package's ``jit(vmap(init_and_fit))``
(``decode_tonal_langauge_tpu/training/seed_parallel.py``): the copies'
parameters and buffers are stacked on a leading seed axis
(``torch.func.stack_module_state``) and a ``meta`` copy of the module is
run on them with ``torch.func.functional_call`` inside ``torch.func.vmap``.
A train step is ``vmap(grad_and_value(loss))``: one forward and one
backward for all seeds, each convolution a ``groups=S`` convolution, each
matmul a batched one, the LSTM's ``autograd.Function`` batched by its
generated vmap rule (``ops/lstm.py``).

- Dropout: ``vmap`` allows no random operation, so :meth:`SeedStack.
  grad_step` draws every seed's masks before the step from that seed's
  generator (``ops/dropout.py``), in the order and shapes of the module's
  forward, which a ``meta`` forward records once (:meth:`SeedStack.
  _dropout_inputs`). Seed s drops the units a fit of seed s alone drops.
- Batch norm (``models/synthesis.BatchNorm1d``) updates its running
  statistics in place; ``functional_call`` writes them into the stacked
  buffers, each seed's row from its own batch.
- A seed leaves the stacks with :meth:`SeedStack.select`.

Nothing here falls back to a loop over the seeds: when a layer has no
batching rule the step raises and names the layer.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call, grad_and_value, stack_module_state, vmap

from ..ops.dropout import Dropout, given_masks
from ..runtime.profiling import span


def _enter(layers: List[str], name: str, *_) -> None:
    layers.append(name)


def _leave(layers: List[str], *_) -> None:
    layers.pop()


class SeedStack:
    """``models`` (one architecture, each seeded and on the CPU) as
    seed-stacked parameters and buffers on ``device``."""

    def __init__(self, models: Sequence[nn.Module], device: torch.device) -> None:
        models = list(models)
        params, buffers = stack_module_state(models)
        self.params: Dict[str, torch.Tensor] = {k: v.detach().to(device)
                                                for k, v in params.items()}
        self.buffers: Dict[str, torch.Tensor] = {k: v.to(device) for k, v in buffers.items()}
        self.keys: List[str] = list(models[0].state_dict())
        self.base = copy.deepcopy(models[0]).to("meta")
        self._dropouts = {name: m for name, m in self.base.named_modules()
                          if isinstance(m, Dropout)}
        for m in self._dropouts.values():
            m.generator = None
        self._draws: Optional[List[Tuple[str, torch.Size, torch.dtype]]] = None
        # The layers whose forward is running. The hooks hold the list, not
        # the stack: a cycle through them would keep the stacked tensors
        # on the device until the garbage collector ran.
        self._layers: List[str] = []
        for name, m in self.base.named_modules():
            m.register_forward_pre_hook(functools.partial(_enter, self._layers, name))
            m.register_forward_hook(functools.partial(_leave, self._layers))

    def n_params(self) -> int:
        """Parameters of one seed's model."""
        return int(sum(v[0].numel() for v in self.params.values()))

    # ------------------------------------------------------------------
    def _dropout_inputs(self, inputs: Sequence[torch.Tensor]):
        """(name, shape, dtype) of each drawing dropout's input, in the
        order a train-mode forward of one seed reaches them, from a
        forward of the ``meta`` module on one seed's shapes."""
        order = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, name=name: order.append((name, args[0].shape, args[0].dtype)))
            for name, m in self._dropouts.items()]
        try:
            with torch.no_grad():
                self.base.train()(*(torch.empty(x.shape[1:], dtype=x.dtype, device="meta")
                                    for x in inputs))
        finally:
            for h in hooks:
                h.remove()
            self._layers.clear()
        return [d for d in order if self._dropouts[d[0]].draws]

    def draw_masks(self, inputs: Sequence[torch.Tensor],
                   generators: Sequence[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Every seed's keep-masks for one train-mode forward of
        ``inputs`` (S, B, ...): seed s's from ``generators[s]``, drawn as
        its own forward draws them; stacked on the seed axis."""
        if self._draws is None:
            self._draws = self._call(self._dropout_inputs, inputs) if self._dropouts else []
        device = inputs[0].device
        per_seed = [[self._dropouts[name].draw(shape, dtype, device, g)
                     for name, shape, dtype in self._draws] for g in generators]
        return {name: torch.stack([masks[i] for masks in per_seed])
                for i, (name, _, _) in enumerate(self._draws)}

    def _call(self, fn: Callable, *args):
        """``fn(*args)``; an error inside the batched computation names the
        layer whose forward was running."""
        self._layers.clear()
        try:
            return fn(*args)
        except Exception as e:
            if self._layers:
                name = self._layers[-1]
                kind = type(self.base.get_submodule(name)).__name__
                where = f"layer {name or '(the model itself)'} ({kind})"
            else:
                where = "the loss or the backward"
            raise RuntimeError(f"seed-batched {type(self.base).__name__}: {where} failed: "
                               f"{e}") from e

    def grad_step(self, inputs: Sequence[torch.Tensor], loss_fn: Callable,
                  loss_args: Sequence[torch.Tensor], generators: Sequence[torch.Generator]):
        """One train-mode forward and backward of every seed. ``inputs``
        and ``loss_args`` carry the seed axis; ``loss_fn(out, *args)`` is
        one seed's scalar loss. Returns (gradients by parameter name, (S,)
        losses, (S, ...) outputs), the outputs without a gradient."""
        with span("seed_stack.masks"):
            masks = self.draw_masks(inputs, generators)
        base = self.base.train()

        def seed_loss(params, buffers, masks, inputs, loss_args):
            with given_masks(self._dropouts, masks), span("seed_stack.forward"):
                out = functional_call(base, (params, buffers), tuple(inputs))
            return loss_fn(out, *loss_args), out

        # the span's self time: the backward outside the LSTM, and vmap's dispatch
        with span("seed_stack.grad_step"):
            grads, (loss, out) = self._call(vmap(grad_and_value(seed_loss, has_aux=True)),
                                            self.params, self.buffers, masks, tuple(inputs),
                                            tuple(loss_args))
        return grads, loss, out

    @torch.no_grad()
    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        """Every seed's eval-mode output on its ``inputs`` (S, B, ...)."""
        base = self.base.eval()
        return self._call(vmap(lambda p, b, x: functional_call(base, (p, b), tuple(x))),
                          self.params, self.buffers, inputs)

    # ------------------------------------------------------------------
    def select(self, keep: torch.Tensor) -> None:
        """Keep the seeds at indices ``keep`` (a long tensor), in that order."""
        self.params = {k: v[keep.to(v.device)] for k, v in self.params.items()}
        self.buffers = {k: v[keep.to(v.device)] for k, v in self.buffers.items()}

    def state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Seed ``i``'s state dict on the host, in the module's key order."""
        both = {**self.params, **self.buffers}
        return {k: both[k][i].detach().cpu().clone() for k in self.keys}
