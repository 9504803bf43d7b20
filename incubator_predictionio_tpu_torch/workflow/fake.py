"""FakeWorkflow — run arbitrary user code through the workflow machinery:
the port's own copy of incubator_predictionio_tpu/workflow/fake.py.

Parity: core/.../workflow/FakeWorkflow.scala:17-109 (``FakeRun``): a user
singleton assigns ``func`` (there ``SparkContext => Unit``, here
``RuntimeContext -> None``) and runs it with ``pio eval module:Obj`` —
useful for experimenting inside the exact runtime environment (storage
configured, the device context built) without writing a real engine.

Example::

    class HelloWorld(FakeRun):
        def __init__(self):
            super().__init__()
            self.func = lambda ctx: print("HelloWorld", ctx.device)

    hello_world = HelloWorld()   # then: pio eval my_module:hello_world
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

from incubator_predictionio_tpu_torch.core.base import Evaluator
from incubator_predictionio_tpu_torch.core.evaluation import Evaluation
from incubator_predictionio_tpu_torch.core.params import EngineParams
from incubator_predictionio_tpu_torch.parallel.context import RuntimeContext


class FakeEngine:
    """FakeWorkflow.scala:32-51 — an engine that produces no eval data."""

    def batch_eval(
        self,
        ctx: RuntimeContext,
        engine_params_list: Sequence[EngineParams],
        params: Any = None,
    ) -> list:
        return []

    def train(self, *args: Any, **kwargs: Any) -> list:
        raise RuntimeError("FakeEngine cannot train; use `pio eval`.")


@dataclasses.dataclass
class FakeEvalResult:
    """FakeWorkflow.scala:69-72 — noSave result; nothing is persisted."""

    no_save: bool = True

    def to_one_liner(self) -> str:
        return "FakeEvalResult"

    def to_jsonable(self) -> dict:
        return {"result": "FakeEvalResult"}

    def to_html(self) -> str:
        return "<p>FakeEvalResult</p>"


class FakeRunner(Evaluator):
    """FakeWorkflow.scala:53-67 — evaluator that just calls the function."""

    def __init__(self, f: Callable[[RuntimeContext], Any]):
        super().__init__()
        self.f = f

    def evaluate(
        self,
        ctx: RuntimeContext,
        evaluation: Any,
        engine_eval_data_set: Sequence[Tuple[EngineParams, Any]],
        params: Any = None,
    ) -> FakeEvalResult:
        self.f(ctx)
        return FakeEvalResult()


class FakeRun(Evaluation):
    """FakeWorkflow.scala:75-109 — assign ``func`` and run via `pio eval`."""

    def __init__(self) -> None:
        super().__init__()
        self.engine_params_list: list[EngineParams] = []

    @property
    def func(self) -> Callable[[RuntimeContext], Any]:
        raise NotImplementedError("write-only (FakeWorkflow.scala:104)")

    @func.setter
    def func(self, f: Callable[[RuntimeContext], Any]) -> None:
        self.engine_evaluator = (FakeEngine(), FakeRunner(f))
        self.engine_params_list = [EngineParams()]
