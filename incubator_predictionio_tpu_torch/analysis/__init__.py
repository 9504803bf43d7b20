"""pio-lint for the PyTorch port: the JAX package's static analysis,
re-pointed at ``incubator_predictionio_tpu_torch``.

A copy of incubator_predictionio_tpu/analysis/__init__.py (:1-27); the
engine, the 23 rules, the whole-program concurrency pass and the CLI are
copies of the JAX package's ``analysis/{engine,rules,concur,__main__}.py``
(each module names the lines it copies). Run ``python -m
incubator_predictionio_tpu_torch.analysis --baseline``: the default scan
is this package, and the baseline is this package's own
``analysis/baseline.json``. Rules and suppression syntax are documented
in ``docs/lint.md``. Rules whose roots are JAX traces (``jit``,
``shard_map``, ``pallas_call``) find nothing in a package without JAX;
they stay, with the same names and severities, so both packages run one
rule set.
"""

from incubator_predictionio_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Module,
    apply_baseline,
    default_baseline_path,
    lint_paths,
    load_baseline,
    package_root,
    repo_root,
    write_baseline,
)
from incubator_predictionio_tpu_torch.analysis.rules import (  # noqa: F401
    ALL_RULES,
    RULES_BY_NAME,
    Rule,
)
