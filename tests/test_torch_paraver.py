"""The port's timeline export against the JAX package's.

``repro_torch.core.write_prv`` / ``ascii_gantt`` and ``repro.core``'s on
the same estimate: one traced application (saved by the reference and
loaded by the port, so both see the same measured task times), each
package's own report map and candidate, each package's ``estimate``.  The
``.prv``, ``.row`` and ``.pcf`` files and the Gantt text are
byte-identical (the ``.prv`` header's date is a fixed string).
"""
import dataclasses

import pytest

from repro.apps import cholesky as ref_ch
from repro.apps import matmul as ref_mm
from repro.core import ascii_gantt as ref_gantt
from repro.core import estimate as ref_estimate
from repro.core import write_prv as ref_write_prv

from repro_torch.apps import cholesky as ch
from repro_torch.apps import matmul as mm
from repro_torch.core import Trace, ascii_gantt, estimate, write_prv

#: (application modules, trace, candidate of each package, smp_scale): the
#: matmul case of ``tests/test_core_estimator.py``'s Paraver test and the
#: paper's Cholesky at n = 512, bs = 64 on a two-accelerator design.
CASES = {
    "matmul256_64": (lambda: ref_mm.trace_matmul(n=256, bs=64),
                     lambda mod: mod.candidates()[64][0],
                     lambda mod: mod.report_map(), 8.0),
    "cholesky512_64": (lambda: ref_ch.trace_cholesky(n=512, bs=64),
                       lambda mod: mod.candidates(bs=64)[-1],
                       lambda mod: mod.report_map(bs=64), 1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paraver_files_and_gantt_match_the_reference(tmp_path, name):
    make_trace, pick, reports, smp_scale = CASES[name]
    ref_mod, mod = {"matmul256_64": (ref_mm, mm),
                    "cholesky512_64": (ref_ch, ch)}[name]
    ref_trace = make_trace()
    path = str(tmp_path / "trace.jsonl")
    ref_trace.save(path)
    trace = Trace.load(path)

    ref_cand, cand = pick(ref_mod), pick(mod)
    ref_reports, port_reports = reports(ref_mod), reports(mod)
    assert cand.name == ref_cand.name
    assert {k: dataclasses.asdict(v) for k, v in port_reports.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_reports.items()}
    ref_est = ref_estimate(ref_trace, ref_cand.system, ref_reports,
                           ref_cand.eligibility, smp_scale=smp_scale)
    est = estimate(trace, cand.system, port_reports, cand.eligibility,
                   smp_scale=smp_scale)
    assert est.makespan_s == ref_est.makespan_s

    ref_prv = ref_write_prv(ref_est.sim, str(tmp_path / "ref"))
    prv = write_prv(est.sim, str(tmp_path / "port"))
    assert prv.endswith("port.prv") and ref_prv.endswith("ref.prv")
    for ext in (".prv", ".row", ".pcf"):
        got = (tmp_path / f"port{ext}").read_bytes()
        assert got == (tmp_path / f"ref{ext}").read_bytes(), ext
        assert got
    assert (tmp_path / "port.prv").read_text().count("\n") > 10
    for kw in ({}, {"width": 60, "max_rows": 4}):
        assert ascii_gantt(est.sim, **kw) == ref_gantt(ref_est.sim, **kw)
