"""Checkpoint / resume for trained weights, optimizer state, and
long-running Monte-Carlo simulations.

The reference has NO persistence for model weights (no ``torch.save``
anywhere — SURVEY §5 "Checkpoint/resume: none"); its only persistence is
simulation-results JSON. Here a checkpoint is a directory holding
``arrays.npz`` (one array per pytree leaf) and ``tree.json`` (each leaf's
key path): weight tables + optimizer state for training, and (RNG key,
error counters, frames) for resumable Monte-Carlo runs. numpy and JSON
only, so it reads back anywhere the package runs.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_trainer_checkpoint",
    "load_trainer_checkpoint",
]

_ARRAYS = "arrays.npz"
_TREE = "tree.json"


def _path_json(path) -> list:
    """A pytree key path as JSON: ["d", key] dict entry, ["i", index]
    sequence entry, ["a", name] attribute (NamedTuple field)."""
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(["d", k.key])
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(["i", k.idx])
        elif isinstance(k, jax.tree_util.GetAttrKey):
            out.append(["a", k.name])
        elif isinstance(k, jax.tree_util.FlattenedIndexKey):
            out.append(["i", k.key])
        else:
            raise TypeError(f"unsupported pytree key {k!r}")
    return out


def _leaves_with_paths(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path_json(p), leaf) for p, leaf in flat], treedef


def _nest(paths, arrays):
    """Rebuild nested dicts/lists from key paths (no template)."""
    root: dict = {}
    for path, a in zip(paths, arrays):
        node = root
        for kind, key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1][1]] = a

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in sorted(node)]
        return node
    return fix(root)


def save_checkpoint(path: str, tree: Any) -> str:
    """Save any pytree (weight dicts, optimizer states, counters) to
    ``path`` (a directory); ``None`` entries are dropped."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, _ = _leaves_with_paths(_strip_none(tree))
    np.savez(os.path.join(path, _ARRAYS),
             **{f"a{i}": np.asarray(x) for i, (_, x) in enumerate(leaves)})
    with open(os.path.join(path, _TREE), "w") as f:
        json.dump([p for p, _ in leaves], f)
    return path


def load_checkpoint(path: str, item: Any = None) -> Any:
    """Restore a pytree saved by :func:`save_checkpoint`.

    ``item``: optional template pytree — the restore is mapped into its
    exact structure (NamedTuple fields, tuple order), which matters for
    optax states; a template whose key paths or leaf shapes differ from
    the saved ones raises ``ValueError``. Without it, dict and sequence
    nodes come back as dicts and lists."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _TREE)) as f:
        paths = [[tuple(e) for e in p] for p in json.load(f)]
    with np.load(os.path.join(path, _ARRAYS)) as z:
        arrays = [z[f"a{i}"] for i in range(len(paths))]
    if item is None:
        return _nest(paths, arrays)
    want, treedef = _leaves_with_paths(item)
    saved = {tuple(map(tuple, p)): a for p, a in zip(paths, arrays)}
    out = []
    for p, leaf in want:
        a = saved.get(tuple(map(tuple, p)))
        if a is None or np.shape(a) != np.shape(leaf):
            raise ValueError(f"checkpoint at {path} has no leaf matching "
                             f"{p} with shape {np.shape(leaf)}")
        out.append(a)
    if len(out) != len(saved):
        raise ValueError(f"checkpoint at {path} holds {len(saved)} leaves, "
                         f"the template {len(out)}")
    return jax.tree_util.tree_unflatten(treedef, out)


def _strip_none(tree):
    if isinstance(tree, dict):
        return {k: _strip_none(v) for k, v in tree.items() if v is not None}
    return tree


def save_trainer_checkpoint(path: str, trainer, epoch: int) -> str:
    """Persist a :class:`~ldpc_tpu.train.PosteriorJointTrainer`'s full
    resumable state: decoder weights, Adam state, history, epoch."""
    state = {
        "weights": {k: v for k, v in trainer.decoder.weights.items()
                    if v is not None},
        "opt_state": trainer.opt_state,
        "epoch": np.int64(epoch),
    }
    save_checkpoint(path, state)
    # history is small & ragged: JSON sidecar
    with open(os.path.join(path, "history.json"), "w") as f:
        json.dump({
            "training_losses": trainer.training_losses,
            "validation_losses": trainer.validation_losses,
            "training_accuracies": trainer.training_accuracies,
            "gradient_norms": trainer.gradient_norms,
        }, f)
    return path


def load_trainer_checkpoint(path: str, trainer) -> int:
    """Restore state saved by :func:`save_trainer_checkpoint` into
    ``trainer``; returns the saved epoch.

    The optimizer state is restored INTO a freshly-initialized template
    (template restore), so NamedTuple field order is preserved, and any
    structure
    mismatch (different optimizer, different weight shapes) raises instead
    of silently resuming with reset Adam moments."""
    raw = load_checkpoint(path)
    w = dict(trainer.decoder.weights)
    for k, v in raw["weights"].items():
        cur = w.get(k)
        if cur is None or np.shape(cur) != np.shape(v):
            raise ValueError(
                f"checkpoint weight {k!r} has shape {np.shape(v)} but this "
                f"trainer's decoder expects "
                f"{None if cur is None else np.shape(cur)}; refusing to "
                "resume into a mismatched decoder")
        w[k] = v
    fresh = trainer.optimizer.init(
        {k: v for k, v in w.items() if v is not None})
    template = {
        "weights": {k: v for k, v in w.items() if v is not None},
        "opt_state": fresh,
        "epoch": np.int64(0),
    }
    try:
        state = load_checkpoint(path, item=template)
    except Exception as e:
        raise ValueError(
            f"checkpoint at {path} does not match this trainer's "
            "weight/optimizer structure; refusing to resume with a "
            f"partially-restored state ({e})") from e
    saved_leaves = jax.tree_util.tree_leaves(state["opt_state"])
    fresh_leaves = jax.tree_util.tree_flatten(fresh)[0]
    if len(saved_leaves) != len(fresh_leaves) or any(
            np.shape(s) != np.shape(f)
            for s, f in zip(saved_leaves, fresh_leaves)):
        raise ValueError(
            f"optimizer state in {path} has a different structure than "
            "this trainer's optimizer; refusing to silently reinitialize")
    trainer.decoder.weights = w
    trainer.opt_state = state["opt_state"]
    hist_path = os.path.join(path, "history.json")
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            hist = json.load(f)
        trainer.training_losses = hist["training_losses"]
        trainer.validation_losses = hist["validation_losses"]
        trainer.training_accuracies = hist["training_accuracies"]
        trainer.gradient_norms = hist["gradient_norms"]
    return int(state["epoch"])
