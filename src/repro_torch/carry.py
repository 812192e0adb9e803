"""State carried across from the JAX package: traces, reports, orders,
and LM weights.

The estimator has no weights.  What a user of the JAX package has built up
is a saved trace (``Trace.save``), a map of kernel cost reports, and the
dispatch orders its replay library discovered (``ReplayLibrary.export``).
All three are plain data, and :func:`import_reference` turns them into the
port's own objects without importing the JAX package: the trace file is
read by the port's :meth:`~repro_torch.core.trace.Trace.load`, each report
is copied field by field, and each order payload is staged on a fresh
:class:`~repro_torch.core.replay.ReplayLibrary`, keyed by the graph's
content hash.  ``FrozenGraph.content_hash()`` is computed identically in
both packages, so an Explorer that builds the same graph finds its orders
and validates them against the graph before replaying any.

The LM substrate does have weights: :func:`import_lm_params` turns the JAX
package's parameter tree (``repro.models.transformer.init``), as numpy
arrays, into the state dict of the port's
:class:`~repro_torch.models.transformer.Transformer`; applied to a tree
of the same structure (a gradient, a moment) it gives the port's tensors
by parameter name.  :func:`import_opt_state` turns the JAX package's
AdamW state into the port's
:class:`~repro_torch.train.optimizer.OptState`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .core.hlsreport import KernelReport, ReportMap
from .core.replay import ReplayLibrary
from .core.trace import Trace
from .models.transformer import ModelConfig
from .train.optimizer import OptState

_REPORT_FIELDS = tuple(f.name for f in dataclasses.fields(KernelReport))


def _report(r: Any) -> KernelReport:
    vals = {name: getattr(r, name) for name in _REPORT_FIELDS}
    vals["resources"] = dict(vals["resources"])
    vals["meta"] = dict(vals["meta"])
    return KernelReport(**vals)


def import_reference(trace_path: str, reports: Mapping[Tuple[str, str], Any],
                     orders: Mapping[Tuple[str, str], Mapping]
                     ) -> Tuple[Trace, ReportMap, ReplayLibrary]:
    """``(trace, reports, library)`` for the port from the JAX package's
    state.

    ``trace_path`` is a file written by ``Trace.save``; ``reports`` maps
    ``(kernel, device_kind)`` to report objects with
    :class:`~repro_torch.core.hlsreport.KernelReport`'s fields;
    ``orders`` maps ``(graph content hash, policy)`` to the payload
    ``ReplayLibrary.export(graph_hash, policy)`` returned.  Pass the
    library to ``Explorer(order_library=...)``."""
    trace = Trace.load(trace_path)
    port_reports = {tuple(key): _report(r) for key, r in reports.items()}
    library = ReplayLibrary()
    for (graph_hash, policy), payload in orders.items():
        library.stage(graph_hash, policy, payload)
    return trace, port_reports, library


def _tensor(a: Any) -> torch.Tensor:
    """A torch tensor with ``a``'s values and type; bf16 arrays (which
    numpy holds as ``ml_dtypes.bfloat16``) go through f32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def import_lm_params(cfg: ModelConfig,
                     params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX package's parameter tree.

    ``params`` is ``repro.models.transformer.init(cfg, key)`` with its
    leaves as numpy arrays: ``embed``, ``final_norm``, optional
    ``lm_head``, optional ``shared`` (zamba2's one attention block,
    un-stacked, which becomes the ``shared`` module), and ``blocks{i}``,
    whose leaves are stacked over the periods.  Period ``p`` of
    ``blocks{i}`` becomes layer ``p * len(cfg.pattern) + i``; an MoE
    layer's ``moe`` (``router.w``, the stacked experts ``gate``/``up``
    ``(E, d, ff)`` and ``down`` ``(E, ff, d)``) and ``shared_mlp`` carry
    under the same names.  whisper's ``encoder.blocks`` (stacked over
    ``encoder_layers``) become ``encoder.layers.{n}``, ``encoder.norm``
    stays, and ``cross`` (stacked over the periods) becomes
    ``cross.{p}``.  Each leaf keeps its type (Mamba2's f32 ``a_log``,
    ``dt_bias`` and ``d_skip``, and the MoE router's f32 ``w``, in a bf16
    model).  Load the result with ``Transformer(cfg).load_state_dict``."""
    n_pat = len(cfg.pattern)
    state: Dict[str, torch.Tensor] = {}

    def unstack(tree: Mapping[str, Any], prefix: str, index) -> None:
        for name, stacked in _flatten(tree, "").items():
            stacked = np.asarray(stacked)
            for p in range(stacked.shape[0]):
                state[f"{prefix}.{index(p)}.{name}"] = _tensor(stacked[p])

    for key, sub in params.items():
        if key.startswith("blocks"):
            i = int(key[len("blocks"):])
            unstack(sub, "layers", lambda p, i=i: p * n_pat + i)
        elif key == "cross":
            unstack(sub, "cross", lambda p: p)
        elif key == "encoder":
            unstack(sub["blocks"], "encoder.layers", lambda p: p)
            state.update({name: _tensor(a) for name, a in _flatten(
                {"norm": sub["norm"]}, "encoder.").items()})
        else:
            state.update({name: _tensor(a)
                          for name, a in _flatten({key: sub}, "").items()})
    return state


def import_opt_state(cfg: ModelConfig, state: Any) -> OptState:
    """The port's optimizer state for the JAX package's
    ``repro.train.optimizer.OptState`` (``step``, ``mu``, ``nu``) with
    numpy leaves: ``mu`` and ``nu`` mapped by :func:`import_lm_params`,
    each moment in its own type, ``step`` an int32 scalar."""
    return OptState(step=torch.tensor(int(np.asarray(state.step)),
                                      dtype=torch.int32),
                    mu=import_lm_params(cfg, state.mu),
                    nu=import_lm_params(cfg, state.nu))
