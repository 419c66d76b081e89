"""repro_torch.audit — static accounting verifier + ECM analytic predictor.

Counterpart of ``repro.audit``; two consumers of ``repro_torch.istream``'s
observations that need no timing (see README.md here):

    verify   declared bytes/flops (the mix registry) vs what runs — the SASS
             of the hand-written kernels (cuda) or the aten operations of
             the oracles (torch) — for every mix x backend x knob
             combination, with explicit detection of deleted timed work and
             formula lint over the registry itself
    ecm      Execution-Cache-Memory-style per-pass time prediction from a
             profile + FittedMachineModel (issue term vs per-level transfer
             terms), validated against measurement and consumed by
             ``core.autotune`` as a block-shape prefilter

Entry points: ``python -m repro_torch.bench audit`` (exit 0 clean, 2 on an
accounting violation) and ``tests/test_torch_audit.py`` (deviceless over
the SASS goldens in ``tests/data_torch/sass/``).
"""
from repro_torch.audit.ecm import (EcmPrediction, ecm_filter_rows,  # noqa: F401
                                   ecm_predict, issue_ceiling,
                                   predict_block_rows, validate_ecm)
from repro_torch.audit.verify import (EXIT_OK, EXIT_VIOLATION,  # noqa: F401
                                      AuditReport, CaseAudit, Check,
                                      audit_case, audit_counts,
                                      audit_goldens, audit_registry,
                                      audit_sass, audit_trace,
                                      default_knob_grid, expected_counts,
                                      lint_mix, random_rw_pairs,
                                      waiver_reason, write_goldens)

__all__ = ["AuditReport", "CaseAudit", "Check", "EXIT_OK", "EXIT_VIOLATION",
           "EcmPrediction", "audit_case", "audit_counts", "audit_goldens",
           "audit_registry", "audit_sass", "audit_trace",
           "default_knob_grid", "ecm_filter_rows", "ecm_predict",
           "expected_counts", "issue_ceiling", "lint_mix",
           "predict_block_rows", "random_rw_pairs", "validate_ecm",
           "waiver_reason", "write_goldens"]
