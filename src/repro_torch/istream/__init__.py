"""repro_torch.istream — the instruction-stream microscope (README.md here).

Counterpart of ``repro.istream``.  The paper's headline finding is that
instruction fetch and issue, not cache bandwidth, throttle cache-resident
loops; this subsystem gives every measured point of the port that second
axis, from what actually runs:

    extract   the SASS of the hand-written kernels (``cuobjdump -sass`` of
              ``build/membench/*.so``): loops, per-trip counts by class,
              the dependent-load critical path
    emulate   runs a launch's SASS for its grid and arguments and counts
              what every thread executes (the dynamic counts)
    analyze   per-case InstructionProfile (cuda: the launches of one timed
              call; torch: the aten operations it dispatches), cached by
              the Runner's knob key minus passes, + bounds
    classify  join measured GB/s points with their profiles (and
              optionally a FittedMachineModel) to label every point
              bandwidth-bound vs issue-bound with a margin

Entry points: ``python -m repro_torch.bench istream`` (CLI), or::

    from repro_torch.istream import run_istream
    report = run_istream(backends=("torch", "cuda"),
                         mixes=("copy", "rw_2to1"))
    print(report.table)
"""
from repro_torch.istream.analyze import (InstructionProfile,  # noqa: F401
                                         ProfileCache, analyze_case, bounds,
                                         fit_issue_rate, record_case)
from repro_torch.istream.classify import (IStreamReport,  # noqa: F401
                                          classify_points, render_fig6,
                                          run_istream, synthetic_check)
from repro_torch.istream.extract import (kernel_loops,  # noqa: F401
                                         parse_sass, sass_of, sass_ops)

__all__ = ["InstructionProfile", "ProfileCache", "analyze_case", "bounds",
           "fit_issue_rate", "record_case", "IStreamReport",
           "classify_points", "render_fig6", "run_istream",
           "synthetic_check", "kernel_loops", "parse_sass", "sass_of",
           "sass_ops"]
