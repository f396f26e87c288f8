"""Checkpoint and resume (counterpart of ``gpflow_slim_tpu.utils.checkpoint``).

``save_checkpoint(path, tree)`` / ``load_checkpoint(path, template)`` take
any nesting of dicts, lists and tuples over ``nn.Module``s (a model, a
``posterior()``), ``torch.optim.Optimizer``s, ``torch.Generator``s (CPU or
CUDA), tensors and plain numbers or strings: a module and an optimizer go
by their ``state_dict()``, a generator by ``get_state()``, all through
``torch.save``. Loading reads with ``torch.load(weights_only=True)`` (no
pickled code runs) and loads in place into the template's modules,
optimizers, generators and tensors, which supply the structure, the
devices and the dtypes. The write goes to a temporary file that
``os.replace`` renames, so a job preempted mid-write never leaves a torn
checkpoint; recovery is a restart from the last one (``latest_checkpoint``).
"""

from __future__ import annotations

import os

import torch
from torch import nn

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def _state(tree):
    """The storable state of ``tree``: containers kept, each module,
    optimizer and generator by its state, tensors detached."""
    if isinstance(tree, dict):
        return {k: _state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_state(v) for v in tree]
    if isinstance(tree, (nn.Module, torch.optim.Optimizer)):
        return tree.state_dict()
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _restore(template, state, where):
    if isinstance(template, dict):
        if not isinstance(state, dict) or set(state) != set(template):
            raise ValueError(f"checkpoint at {where or 'the root'} does not match the template's keys")
        return type(template)((k, _restore(v, state[k], f"{where}[{k!r}]")) for k, v in template.items())
    if isinstance(template, (list, tuple)):
        if not isinstance(state, list) or len(state) != len(template):
            raise ValueError(f"checkpoint at {where or 'the root'} does not match the template's length")
        out = [_restore(v, s, f"{where}[{i}]") for i, (v, s) in enumerate(zip(template, state))]
        return out if isinstance(template, list) else type(template)(out)
    if isinstance(template, (nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(state)
    elif isinstance(template, torch.Generator):
        template.set_state(state.cpu())
    elif isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(state)
    else:
        return state
    return template


def _device(tree):
    """The device of the template's first tensor (cpu if it has none)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((d for d in map(_device, tree) if d is not None), None)
    if isinstance(tree, nn.Module):
        return next((t.device for t in tree.state_dict().values()), None)
    if isinstance(tree, torch.Tensor):
        return tree.device
    return None


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Write ``tree``'s state to ``path`` (or ``{path}-{step}``, a numbered
    history) through a temporary file and ``os.replace``. Returns the
    path written."""
    if step is not None:
        path = f"{path}-{step}"
    state = _state(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, template):
    """Load the checkpoint at ``path`` into ``template``, a tree of the
    structure it was saved from: its modules, optimizers, generators and
    tensors are loaded in place (on their own devices), its other leaves
    replaced by the stored values. Returns the template's structure with
    those leaves (the template itself when it is a module)."""
    state = torch.load(path, map_location=_device(template) or "cpu", weights_only=True)
    return _restore(template, state, "")


def latest_checkpoint(path: str) -> str | None:
    """The highest-numbered ``{path}-{step}`` file, else ``path`` itself if
    it exists, else None."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    best, best_step = None, -1
    if os.path.exists(path):
        best = path
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(base + "-"):
                try:
                    step = int(name[len(base) + 1:])
                except ValueError:
                    continue
                if step > best_step:
                    best, best_step = os.path.join(d, name), step
    return best
