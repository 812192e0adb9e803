"""The applications whose traces the benchmark generates, one module each.

A configuration file names its application under ``"app"``; the module
``portbench.apps.<app>`` gives ``events(config)``, the trace as plain
event dicts (the shape of ``TraceEvent.to_json``), and
``design_space(config)``, the candidates as plain dicts (``name``,
``accelerators``: kind -> slots, ``eligibility``: kernel -> kinds,
``fabric``: kind -> slots instantiated in the fabric).  Each
loop nest is a frozen copy of the application's, with symbolic region
keys in place of buffer addresses: dependences are matched by key alone.
"""
from __future__ import annotations

import importlib
from typing import Dict, Mapping


def event(index: int, name: str, accesses, devices, flops: float,
          smp: Mapping) -> Dict:
    """One task instance; a region key ``("A", i, k)`` becomes the string
    ``"A:i:k"``.  ``elapsed_smp`` is the target SMP's time for
    its work (``flops / (gflops * 1e9)``, the A9 model of the
    configuration): what an instrumented run on the board would record."""
    return {"index": index, "name": name, "created_at": 0.0,
            "elapsed_smp": flops / (smp["gflops"] * 1e9),
            "accesses": [[":".join(map(str, key)), d, n]
                         for key, d, n in accesses],
            "devices": list(devices), "flops": flops, "meta": {}}


def load(config: Mapping):
    """The application module of ``config``."""
    return importlib.import_module(f"portbench.apps.{config['app']}")


def inputs(config: Mapping) -> Dict:
    """Everything the port and the reference are both handed: the trace's
    events, the kernel reports, the system constants, the SMP cost model
    and the design space."""
    app = load(config)
    return {"events": app.events(config), "reports": config["reports"],
            "system": config["system"], "smp": config["smp"],
            "design_space": app.design_space(config)}
