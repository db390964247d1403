"""TF1 ``tf.train.Saver`` checkpoint → port generator ``state_dict`` —
counterpart of ``mpgan_tpu/utils/tf1_import.py``.

The reference saves ``tf.train.Saver`` checkpoints (TensorBundle V2:
``model.ckpt.index`` + ``.data-00000-of-*``); ``tf.train.load_checkpoint``
reads them under TF2 without a TF1 runtime. TensorFlow is imported only
when a checkpoint is read, so everything else here works without it.

TF1 ``conv2d`` kernels are ``(kh, kw, cin, cout)`` and dense kernels
``(in, out)``: the flax layouts. So the variables are matched against the
generator's parameters in their flax form (flat ``stem/kernel`` keys,
:func:`mpgan_torch.convert.state_dict_to_flax`), and the matched tree goes
back to a ``state_dict`` through :func:`mpgan_torch.convert.
flax_to_state_dict` (:func:`import_state_dict`). Only names differ, and
the reference's scopes are unknown, so the mapper has two modes:

1. an explicit ``name_map``: flax key (``"block_0_0/conv1/kernel"``) → TF
   variable name;
2. shape-greedy auto-match: the flax leaves, in sorted key order (flax's
   leaf order), each claim the first unused TF variable of the same shape
   (TF names sorted); ties are reported for review.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mpgan_torch import convert

__all__ = ["read_tf1_variables", "auto_match", "import_params",
           "import_state_dict"]


def _tf_reader(ckpt_path: str):
    try:
        import tensorflow as tf  # noqa: PLC0415 (heavy: only when reading)
    except ImportError as e:  # pragma: no cover - only without TensorFlow
        raise ImportError(
            "importing TF1 checkpoints requires the tensorflow package "
            "(only the CheckpointReader is used, no graph is built)") from e
    return tf.train.load_checkpoint(ckpt_path)


def read_tf1_variables(ckpt_path: str,
                       exclude_optimizer: bool = True
                       ) -> dict[str, np.ndarray]:
    """All variables of a TF1 Saver checkpoint as ``{name: ndarray}``.

    ``exclude_optimizer`` drops Adam/Momentum/RMSProp slot variables and
    the step and power counters: an import wants the model's weights."""
    reader = _tf_reader(ckpt_path)
    out: dict[str, np.ndarray] = {}
    for name in sorted(reader.get_variable_to_shape_map()):
        base = name.split("/")[-1]
        if exclude_optimizer and (
                base.startswith(("Adam", "Momentum", "RMSProp"))
                or name in ("global_step", "beta1_power", "beta2_power")
                or base in ("beta1_power", "beta2_power")):
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out


def _flat_params(params: Mapping) -> list[tuple[str, np.ndarray]]:
    """Flat ``a/b/kernel`` keys (a nested flax tree is flattened, its
    ``params`` root dropped) in flax's leaf order: sorted keys, which is
    the nested order because ``/`` sorts before every name character."""
    flat = (dict(params) if all(isinstance(v, np.ndarray)
                                for v in params.values())
            else convert.flatten_params(params))
    return sorted((k, np.asarray(v)) for k, v in flat.items())


def auto_match(tf_vars: Mapping[str, np.ndarray], params: Mapping
               ) -> tuple[dict[str, str], list[str]]:
    """Shape-greedy matching: flax key → TF variable name.

    Returns ``(mapping, ambiguous)``: ``ambiguous`` lists the keys that had
    more than one unused same-shape candidate (matched to the first by
    name). Raises ``ValueError`` naming every unmatched key, with the
    checkpoint's shapes, when the checkpoint cannot cover the template."""
    unused = dict(tf_vars)
    mapping: dict[str, str] = {}
    ambiguous: list[str] = []
    missing: list[str] = []
    for key, leaf in _flat_params(params):
        # sorted: the tie-break must not depend on the dict's order
        cands = sorted(n for n, v in unused.items() if v.shape == leaf.shape)
        if not cands:
            missing.append(f"{key} {leaf.shape}")
            continue
        if len(cands) > 1:
            ambiguous.append(key)
        mapping[key] = cands[0]
        del unused[cands[0]]
    if missing:
        avail = ", ".join(f"{n}{tuple(v.shape)}" for n, v in
                          sorted(tf_vars.items()))
        raise ValueError(
            "no same-shape TF variable for flax leaves: "
            + "; ".join(missing) + f". Checkpoint offers: {avail}")
    return mapping, ambiguous


def import_params(tf_vars: Mapping[str, np.ndarray], params_template: Mapping,
                  name_map: Mapping[str, str] | None = None,
                  dtype: Any = np.float32
                  ) -> tuple[dict[str, np.ndarray], dict[str, str],
                             list[str]]:
    """Flat flax params from TF1 variables.

    ``name_map`` (flax key → TF name) overrides auto-matching for the keys
    it covers; the other keys are auto-matched against the variables the
    map leaves. Shapes are checked key by key. → ``(params, mapping used,
    ambiguous)``."""
    name_map = dict(name_map or {})
    flat = _flat_params(params_template)
    template_keys = {k for k, _ in flat}
    stale = sorted(set(name_map) - template_keys)
    if stale:
        # an unchecked entry would withhold its TF variable from the
        # auto-match while the real key takes another one: wrong weights
        raise KeyError(
            f"name_map keys not in the param template: {stale}. "
            f"Template keys: {sorted(template_keys)}")
    for key, leaf in flat:
        if key in name_map:
            tf_name = name_map[key]
            if tf_name not in tf_vars:
                raise KeyError(f"name_map sends {key!r} to {tf_name!r}, "
                               "which is not in the checkpoint")
            if tuple(tf_vars[tf_name].shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: flax {tuple(leaf.shape)} vs "
                    f"TF {tf_name} {tuple(tf_vars[tf_name].shape)}")
    mapped_tf = set(name_map.values())
    rest = {k: v for k, v in flat if k not in name_map}
    ambiguous: list[str] = []
    if rest:
        sub_tf = {n: v for n, v in tf_vars.items() if n not in mapped_tf}
        auto, ambiguous = auto_match(sub_tf, rest)
        name_map.update(auto)
    params = {key: np.asarray(tf_vars[name_map[key]], dtype=dtype)
              for key, _ in flat}
    return params, name_map, ambiguous


def import_state_dict(tf_vars: Mapping[str, np.ndarray],
                      gen: torch.nn.Module,
                      name_map: Mapping[str, str] | None = None
                      ) -> tuple[dict[str, torch.Tensor], dict[str, str],
                                 list[str]]:
    """TF1 variables → a ``state_dict`` for the port generator ``gen``
    (its own parameters are the template). → ``(state_dict, mapping,
    ambiguous)``."""
    template = convert.state_dict_to_flax(gen.state_dict())
    params, mapping, ambiguous = import_params(tf_vars, template, name_map)
    return convert.flax_to_state_dict(params), mapping, ambiguous
