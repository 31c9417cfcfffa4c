"""Pretrained-decoder zoo: portable save/load of trained decoders.

A zoo entry is a directory:

    spec.json        decoder recipe + code description + user metadata
    weights.npz      the trained weight tables (dense [T, buckets])
    protograph.txt   (QC codes) shift matrix + lift — codes.save_protograph
    code.alist       (general codes) standard alist of H

Unlike the training checkpoints (``utils/checkpoint.py``, which also
carry optimizer state and are tied to a Trainer), zoo entries are small,
text+npz, dependency-free, and self-describing: ``load_pretrained`` rebuilds
the exact decoder (code, variant, quantizers, schedule) and installs the
weights. This is the deployment format — the reference has no counterpart
(trained weights die with the process; SURVEY §5 checkpointing row).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = ["save_pretrained", "load_pretrained", "list_pretrained",
           "DEFAULT_ZOO_DIR"]

_FORMAT = 1
# repo-relative default: committed entries live in <repo>/zoo/
DEFAULT_ZOO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")


def _qc_base_matrix(qc) -> np.ndarray:
    """Reconstruct the protograph shift matrix from a QCGraph."""
    B = np.full((qc.mb, qc.nb), -1, dtype=np.int64)
    B[qc.block_row, qc.block_col] = qc.block_shift
    return B


def save_pretrained(path: str, decoder, meta: Optional[dict] = None) -> str:
    """Persist ``decoder`` (built by :func:`ldpc_tpu.make_decoder` or any
    factory that goes through it) as a zoo entry at directory ``path``.

    ``meta`` is free-form JSON-able provenance (training config, measured
    FER points, date) stored verbatim and returned by
    :func:`list_pretrained`.
    """
    from ldpc_tpu.codes import save_alist, save_protograph

    if decoder.recipe is None:
        raise ValueError(
            "decoder has no recipe (hand-assembled Decoder?); build it via "
            "make_decoder so the zoo can reconstruct it")
    os.makedirs(path, exist_ok=True)

    if decoder.qc is not None:
        code_desc = {"type": "qc", "file": "protograph.txt"}
        save_protograph(_qc_base_matrix(decoder.qc), decoder.qc.lift,
                        os.path.join(path, "protograph.txt"))
    else:
        code_desc = {"type": "alist", "file": "code.alist"}
        save_alist(decoder.code, os.path.join(path, "code.alist"))

    present = {k: np.asarray(v) for k, v in decoder.weights.items()
               if v is not None}
    none_keys = sorted(k for k, v in decoder.weights.items() if v is None)
    np.savez(os.path.join(path, "weights.npz"), **present)

    spec = {
        "format": _FORMAT,
        "name": decoder.name,
        "recipe": decoder.recipe,
        "code": code_desc,
        "none_weight_keys": none_keys,
        "meta": meta or {},
    }
    spec_path = os.path.join(path, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=2)
    return spec_path


def load_pretrained(path: str, *, qc_options: Optional[dict] = None,
                    max_iterations: Optional[int] = None):
    """Rebuild the decoder saved at ``path`` with its trained weights.

    ``qc_options`` overrides the (deployment-specific, deliberately
    unsaved) engine tuning — e.g. ``{"fused": True, "batch_tile": 64,
    "dtype": jnp.bfloat16}``. ``max_iterations`` may REDUCE the schedule
    (weights tables are [T, ...]-sliced); raising it beyond the trained T
    is refused because no trained weights exist for the extra iterations.
    """
    import ldpc_tpu
    from ldpc_tpu.codes import load_alist, load_protograph
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    if (not os.path.exists(os.path.join(path, "spec.json"))
            and os.path.sep not in path):
        # bare entry name: resolve against the default zoo directory
        # (the names list_pretrained shows)
        cand = os.path.join(DEFAULT_ZOO_DIR, path)
        if os.path.exists(os.path.join(cand, "spec.json")):
            path = cand
    with open(os.path.join(path, "spec.json")) as f:
        spec = json.load(f)
    if spec.get("format") != _FORMAT:
        raise ValueError(f"unknown zoo entry format {spec.get('format')!r}")
    recipe = dict(spec["recipe"])
    T_saved = recipe["max_iterations"]
    T = T_saved if max_iterations is None else max_iterations
    if T > T_saved:
        raise ValueError(
            f"entry was trained at T={T_saved}; cannot extend to {T}")
    recipe["max_iterations"] = T
    recipe["quantizer_params"] = [tuple(p)
                                  for p in recipe["quantizer_params"]]
    if recipe.get("v2c_quantizer_params") is not None:
        recipe["v2c_quantizer_params"] = [
            tuple(p) for p in recipe["v2c_quantizer_params"]]

    qc = None
    if spec["code"]["type"] == "qc":
        base, lift = load_protograph(
            os.path.join(path, spec["code"]["file"]))
        code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
        qc = build_qc_graph(base, lift)
    else:
        code = load_alist(os.path.join(path, spec["code"]["file"]),
                          max_iterations=T)

    dec = ldpc_tpu.make_decoder(code, qc=qc, qc_options=qc_options,
                                **recipe)
    saved = np.load(os.path.join(path, "weights.npz"))
    weights: Dict[str, Optional[jnp.ndarray]] = {
        k: None for k in spec["none_weight_keys"]}
    for k in saved.files:
        a = saved[k]
        # weight tables are [T_saved, ...]; honor a reduced schedule
        weights[k] = jnp.asarray(a[:T] if a.ndim >= 1 and
                                 a.shape[0] == T_saved and T < T_saved
                                 else a)
    missing = set(dec.weights) - set(weights)
    if missing:
        raise ValueError(f"zoo entry {path} is missing weights {missing}")
    dec.weights = {k: weights[k] for k in dec.weights}
    return dec


def list_pretrained(root: str = DEFAULT_ZOO_DIR) -> List[Tuple[str, dict]]:
    """Scan ``root`` for zoo entries; returns [(entry_path, spec dict)]."""
    out: List[Tuple[str, dict]] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        sp = os.path.join(root, name, "spec.json")
        if os.path.exists(sp):
            with open(sp) as f:
                out.append((os.path.join(root, name), json.load(f)))
    return out
