"""``pio`` CLI of the port: ``python -m incubator_predictionio_tpu_torch.
cli.main <verb>``.

The port's counterpart of incubator_predictionio_tpu/cli/main.py (Console.
scala:153-600): version / status / app {new,list,show,delete,data-delete,
channel-new,channel-delete} / accesskey {new,list,delete} / build /
unregister / train / eval / deploy / undeploy / eventserver /
adminserver / storageserver / dashboard / export / import / upgrade / run /
template {get,list}. ``train``, ``eval`` and
``deploy`` run in process on the CUDA device; ``PIO_DEVICE=cpu`` is the one
switch that runs them on the CPU (the JAX package's ``JAX_PLATFORMS=cpu``).
Nothing picks the CPU because no card was found: without the switch, a
process with no CUDA device refuses them (:func:`_ensure_accelerator`). The other verbs never
touch the device. ``deploy`` serves ``/queries.json`` through the
continuous-batching scheduler (``serving/scheduler.py``), set by the same
environment as the JAX package's: ``PIO_SERVE_MAX_BATCH`` (the ladder cap,
512; 0 serves one query a call), ``PIO_SERVE_WORKERS``,
``PIO_SERVE_MAX_WAIT_MS``, ``PIO_SERVE_SHED`` and ``PIO_SLO_SERVE_P99_S``;
``PIO_TENANTS`` names the tenants whose access keys it takes; ``POST
/reload`` swaps in the latest trained instance while it serves. ``deploy
--feedback`` posts every answer back to the event server at
``--event-server-ip``/``--event-server-port`` as a ``predict`` event
under ``--accesskey``, and ``--log-url`` ships query errors to a
collector, each prefixed with ``--log-prefix`` (JAX main.py:107-115,
501-514).

``run <module:attr> [args...]`` (JAX main.py:590-595) resolves its target
as ``train`` resolves a factory, calls it with the arguments and prints a
result that is not None; ``template {get,list}`` prints the notice that
the command is deprecated (JAX main.py:597-600).

``eval <module:Evaluation> [<module:EngineParamsGenerator>]`` (JAX
main.py:456-491) resolves both objects as ``train`` resolves a factory
(a JAX module name maps to the port's), runs
``CoreWorkflow.run_evaluation`` and writes the winner's params to
``--output-best``; a module that loads the JAX package is refused, since
its objects would run there and not here (the port's twin of
``examples/recommendation-quickstart/evaluation.py`` is in the README).

``storageserver`` (JAX main.py:561-575) exports this box's storage to
other boxes over ``POST /rpc``: by default each repository routes to its
own configured source (``--source NAME`` exports one), and the verbs of
other processes reach it through ``PIO_STORAGE_SOURCES_<N>_TYPE=remote``;
it prints ``Storage Server running on http://<ip>:<port>`` once bound
(``--port 0`` binds a free port) and stops with exit 0 on SIGTERM. Like
``eventserver``, it never initialises CUDA.

``dashboard`` (JAX main.py:553-558) serves the completed evaluations and
the live latency, SLO and tenant panels (``servers/dashboard.py``); it
prints ``Dashboard running on http://<ip>:<port>`` once bound and stops
with exit 0 on SIGTERM, and never initialises CUDA.

``adminserver`` (JAX main.py:545-551) serves app CRUD and hosts the
freshness and knob controllers (``servers/admin.py``; ``GET/POST
/controller`` and ``/knobs``, ``/federate``, ``/slo``, ``/incident(s)``,
``/recorder``, ``/metrics``, ``POST /profile``); it prints ``Admin API
running on http://<ip>:<port>`` once bound, stops with exit 0 on SIGTERM,
and never initialises CUDA: as in the JAX package, its freshness
controller is reload-only (``PIO_CONTROLLER_RELOAD_URL``) unless an
embedder wires a retrain in (``obs.controller.workflow_retrain_fn``).

Not ported yet, and each raises ``NotImplementedError`` naming its ROADMAP
item: ``train``/``eval``/
``deploy --hosts`` (the pod launch) and ``train --model-parallelism``
above 1 (item 9). ``pio train`` continues from the last COMPLETED instance, as the JAX
package's does (``ops/retrain.py``). The JAX package's storage-verb platform pin, its private-API backend
probe and its persistent compile cache have no counterpart: nothing here
initialises CUDA unless a verb needs it, and the kernels' build cache is
``runtime.build_kernels()``'s ``_build/``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import List, Optional

from incubator_predictionio_tpu_torch import __version__, runtime
from incubator_predictionio_tpu_torch.cli import commands
from incubator_predictionio_tpu_torch.cli.commands import CommandError


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pio",
        description="PredictionIO-compatible machine learning server on "
                    "PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version",
                        version=f"pio-torch {__version__}")
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("version", help="show version")
    sub.add_parser("status", help="validate storage + compute configuration")

    # -- app ---------------------------------------------------------------
    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_command"
    )
    p = app.add_parser("new")
    p.add_argument("name")
    p.add_argument("--id", type=int, default=0)
    p.add_argument("--description")
    p.add_argument("--access-key", default="")
    app.add_parser("list")
    p = app.add_parser("show")
    p.add_argument("name")
    p = app.add_parser("delete")
    p.add_argument("name")
    p.add_argument("-f", "--force", action="store_true")
    p = app.add_parser("data-delete")
    p.add_argument("name")
    p.add_argument("--channel")
    p.add_argument("-f", "--force", action="store_true")
    p = app.add_parser("channel-new")
    p.add_argument("name")
    p.add_argument("channel")
    p = app.add_parser("channel-delete")
    p.add_argument("name")
    p.add_argument("channel")
    p.add_argument("-f", "--force", action="store_true")

    # -- accesskey ---------------------------------------------------------
    ak = sub.add_parser("accesskey", help="manage access keys").add_subparsers(
        dest="accesskey_command"
    )
    p = ak.add_parser("new")
    p.add_argument("app_name")
    p.add_argument("--key", default="")
    p.add_argument("--events", nargs="*", default=[])
    p = ak.add_parser("list")
    p.add_argument("app_name", nargs="?")
    p = ak.add_parser("delete")
    p.add_argument("key")

    # -- engine lifecycle --------------------------------------------------
    for name, help_text in (
        ("build", "validate the engine in the current directory"),
        ("train", "train the engine in the current directory"),
        ("deploy", "deploy the latest trained engine instance"),
    ):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("--variant", default="engine.json")
        if name in ("train", "deploy"):
            p.add_argument(
                "--hosts", default="",
                help="comma-separated pod hosts (not ported yet: "
                     "ROADMAP.md Queue 1 item 9)")
        if name == "train":
            p.add_argument("--batch", default="")
            p.add_argument("--skip-sanity-check", action="store_true")
            p.add_argument("--stop-after-read", action="store_true")
            p.add_argument("--stop-after-prepare", action="store_true")
            p.add_argument("--seed", type=int, default=0)
            p.add_argument(
                "--model-parallelism", type=int, default=1,
                help="devices a model is split over (only 1 is ported: "
                     "ROADMAP.md Queue 1 item 9)")
        if name == "deploy":
            p.add_argument("--ip", default="0.0.0.0")
            p.add_argument("--port", type=int, default=8000)
            p.add_argument("--engine-instance-id")
            p.add_argument("--event-server-ip", default="0.0.0.0")
            p.add_argument("--event-server-port", type=int, default=7070)
            p.add_argument("--accesskey", default=None)
            p.add_argument("--feedback", action="store_true")
            p.add_argument("--server-key", default=None)
            p.add_argument("--log-url", default=None,
                           help="POST query errors to this collector URL")
            p.add_argument("--log-prefix", default="",
                           help="prefix prepended to each shipped log line")

    sub.add_parser("unregister",
                   help="unregister the engine in the current directory")

    p = sub.add_parser("eval", help="run evaluation / hyperparameter tuning")
    p.add_argument("evaluation_class",
                   help="module:attr of the Evaluation object")
    p.add_argument("engine_params_generator_class", nargs="?",
                   help="module:attr of the EngineParamsGenerator")
    p.add_argument("--batch", default="")
    p.add_argument("--output-best", default="best.json")
    p.add_argument("--hosts", default="",
                   help="comma-separated pod hosts (not ported yet: "
                        "ROADMAP.md Queue 1 item 9)")

    p = sub.add_parser("undeploy", help="stop a deployed engine server")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-key", default=None)

    # -- servers -----------------------------------------------------------
    p = sub.add_parser("eventserver", help="start the event server")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7070)
    p.add_argument("--stats", action="store_true")

    def _positive_int(v: str) -> int:
        n = int(v)
        if n <= 0:
            raise argparse.ArgumentTypeError(
                f"must be a positive integer (got {v})")
        return n

    p.add_argument(
        "--batch-cap", type=_positive_int, default=None, metavar="N",
        help="max events per POST /batch/events.json (default 50 — the "
             "reference's wire contract; raise for bulk loaders)")
    p = sub.add_parser("adminserver", help="start the admin API server")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7071)
    p = sub.add_parser("dashboard", help="start the evaluation dashboard")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9000)
    p = sub.add_parser(
        "storageserver",
        help="export this box's storage source to other boxes "
             "(point their PIO_STORAGE_SOURCES_<N>_TYPE=remote at it)")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7077)
    p.add_argument("--source", default=None,
                   help="export ONE PIO_STORAGE_SOURCES_<NAME>; default "
                        "routes by repository (metadata/eventdata/"
                        "modeldata each to its configured source)")
    p.add_argument("--auth-key", default=None,
                   help="shared key clients must send (X-Pio-Storage-Key)")

    # -- data --------------------------------------------------------------
    p = sub.add_parser("export",
                       help="export app events to JSON lines or parquet")
    p.add_argument("--appid-or-name", dest="app_name", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--channel")
    p.add_argument("--format", choices=("json", "parquet"), default="json")
    p = sub.add_parser("import", help="import exported events into an app")
    p.add_argument("--appid-or-name", dest="app_name", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--channel")
    p.add_argument("--format", choices=("json", "parquet"), default="json")

    # -- misc --------------------------------------------------------------
    p = sub.add_parser("run", help="run an arbitrary main in the engine env")
    p.add_argument("main_class")
    p.add_argument("args", nargs="*")
    tpl = sub.add_parser("template", help="(deprecated)").add_subparsers(
        dest="template_command"
    )
    tpl.add_parser("get")
    tpl.add_parser("list")
    p = sub.add_parser(
        "upgrade", help="rewrite event stores in the current format")
    p.add_argument("app", nargs="?", default=None,
                   help="app name or id (default: every app)")

    return parser


def _confirm(prompt: str, force: bool) -> bool:
    if force:
        return True
    answer = input(f"{prompt} (YES to confirm): ")
    return answer == "YES"


def _ensure_accelerator(timeout_s: float) -> None:
    """Fail fast, with an actionable message, when the CUDA device cannot
    initialise: the counterpart of the JAX package's probe of
    ``jax.devices()``. CUDA initialises (``torch.cuda.init()`` and the
    first device's properties) on a daemon thread, which is given
    ``timeout_s`` (``PIO_ACCEL_INIT_TIMEOUT_S``, default 180); a blocked
    probe is a waiter, and the ``CommandError`` raised here leaves through
    a normal interpreter exit."""
    done = threading.Event()
    err: list = []

    def probe() -> None:
        try:
            import torch

            torch.cuda.init()
            torch.cuda.get_device_properties(0)
        except BaseException as e:  # surfaced as the real failure below
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=probe, daemon=True, name="pio-accel-probe")
    t.start()
    if not done.wait(timeout_s):
        raise CommandError(
            f"the CUDA device did not initialize within {timeout_s:.0f}s; "
            "another process may hold it. Stop it (`pio undeploy`, kill "
            "the process) and retry, or raise PIO_ACCEL_INIT_TIMEOUT_S.")
    if err:
        raise CommandError(
            f"accelerator initialization failed: {err[0]} (set "
            "PIO_DEVICE=cpu to run on the CPU)")


def _accel_timeout_s() -> float:
    raw = os.environ.get("PIO_ACCEL_INIT_TIMEOUT_S", "180")
    try:
        return float(raw)
    except ValueError:
        print(f"warning: PIO_ACCEL_INIT_TIMEOUT_S={raw!r} is not a "
              "number; using 180", file=sys.stderr)
        return 180.0


def _serve_until_signalled(server, announce: str) -> None:
    """Run ``server`` (``start_background`` / ``stop``) until SIGTERM or
    SIGINT, then stop it: the verb returns 0 after a graceful stop."""
    stop = threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        port = server.start_background()
        print(announce.format(port=port), flush=True)
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def dispatch(args: argparse.Namespace) -> int:  # noqa: C901
    cmd = args.command
    if cmd is None:
        build_parser().print_help()
        return 1
    if cmd in ("train", "eval", "deploy") and args.hosts:
        raise NotImplementedError(
            f"pio {cmd} --hosts (the pod launch) is not ported yet: "
            "ROADMAP.md Queue 1 item 9")
    if cmd == "train" and args.model_parallelism != 1:
        raise NotImplementedError(
            "pio train --model-parallelism above 1 (a model split over "
            "devices) is not ported yet: ROADMAP.md Queue 1 item 9")
    if cmd in ("status", "train", "eval", "deploy") \
            and runtime.requested_device() != "cpu":
        _ensure_accelerator(_accel_timeout_s())
    if cmd in ("deploy", "eventserver", "adminserver", "storageserver",
               "dashboard"):
        # long-running server verbs log one JSON span line per request on
        # stderr (PIO_TRACE_LOG=off disables)
        from incubator_predictionio_tpu_torch.obs.trace import (
            enable_span_logging,
        )

        enable_span_logging()
    if cmd == "version":
        print(f"pio-torch {__version__}")
        return 0

    if cmd == "status":
        return 0 if commands.status() else 1

    if cmd == "app":
        ac = args.app_command
        if ac == "new":
            commands.app_new(args.name, args.id, args.description,
                             args.access_key)
        elif ac == "list":
            commands.app_list()
        elif ac == "show":
            commands.app_show(args.name)
        elif ac == "delete":
            if not _confirm(f"Delete app {args.name} and ALL its data?",
                            args.force):
                print("Aborted.")
                return 1
            commands.app_delete(args.name)
        elif ac == "data-delete":
            if not _confirm(f"Delete ALL data of app {args.name}?", args.force):
                print("Aborted.")
                return 1
            commands.app_data_delete(args.name, args.channel)
        elif ac == "channel-new":
            commands.channel_new(args.name, args.channel)
        elif ac == "channel-delete":
            if not _confirm(
                f"Delete channel {args.channel} of app {args.name}?",
                args.force,
            ):
                print("Aborted.")
                return 1
            commands.channel_delete(args.name, args.channel)
        else:
            print("Usage: pio app {new,list,show,delete,data-delete,"
                  "channel-new,channel-delete}")
            return 1
        return 0

    if cmd == "accesskey":
        kc = args.accesskey_command
        if kc == "new":
            commands.accesskey_new(args.app_name, args.key,
                                   tuple(args.events))
        elif kc == "list":
            commands.accesskey_list(args.app_name)
        elif kc == "delete":
            commands.accesskey_delete(args.key)
        else:
            print("Usage: pio accesskey {new,list,delete}")
            return 1
        return 0

    if cmd == "build":
        commands.build(engine_json=args.variant)
        print("No compilation step is needed; your engine is ready to train.")
        return 0

    if cmd == "unregister":
        commands.unregister()
        return 0

    if cmd == "train":
        from incubator_predictionio_tpu_torch.core.params import (
            WorkflowParams,
        )
        from incubator_predictionio_tpu_torch.workflow.workflow import (
            CoreWorkflow,
        )

        variant = commands.load_variant(args.variant)
        engine, engine_params = commands.engine_from_variant(variant)
        params = WorkflowParams(
            batch=args.batch,
            skip_sanity_check=args.skip_sanity_check,
            stop_after_read=args.stop_after_read,
            stop_after_prepare=args.stop_after_prepare,
            runtime_conf={"seed": str(args.seed)},
        )
        instance_id = CoreWorkflow.run_train(
            engine,
            engine_params,
            engine_id=commands.engine_id_for_variant_path(args.variant,
                                                          variant),
            engine_version=variant.get("version", "NOT_VERSIONED"),
            engine_variant=variant.get("id", "default"),
            engine_factory=variant.get("engineFactory", ""),
            params=params,
            device=runtime.requested_device(),
        )
        print(f"Training completed. Engine instance ID: {instance_id}")
        return 0

    if cmd == "eval":
        from incubator_predictionio_tpu_torch.core.params import (
            WorkflowParams,
        )
        from incubator_predictionio_tpu_torch.workflow.workflow import (
            CoreWorkflow,
        )

        evaluation = commands.resolve_port_object(args.evaluation_class)
        if args.engine_params_generator_class:
            params_list = commands.resolve_port_object(
                args.engine_params_generator_class).engine_params_list
        else:
            params_list = getattr(evaluation, "engine_params_list", None)
            if not params_list:
                raise CommandError(
                    "Provide an EngineParamsGenerator class or set "
                    "engine_params_list on the Evaluation.")
        evaluator = evaluation.evaluator
        if args.output_best and hasattr(evaluator, "output_path"):
            evaluator.output_path = args.output_best
        instance_id, result = CoreWorkflow.run_evaluation(
            evaluation, params_list,
            evaluation_class=args.evaluation_class,
            engine_params_generator_class=(
                args.engine_params_generator_class or ""),
            params=WorkflowParams(batch=args.batch),
            device=runtime.requested_device(),
        )
        print(result.to_one_liner())
        print(f"Evaluation completed. Instance ID: {instance_id}")
        return 0

    if cmd == "deploy":
        from incubator_predictionio_tpu_torch.servers.prediction_server import (
            PredictionServer,
            ServerConfig,
        )

        variant = commands.load_variant(args.variant)
        engine, _params = commands.engine_from_variant(variant)
        server = PredictionServer(engine, device=runtime.requested_device(),
                                  config=ServerConfig(
            ip=args.ip,
            port=args.port,
            engine_instance_id=args.engine_instance_id,
            engine_id=commands.engine_id_for_variant_path(args.variant,
                                                          variant),
            engine_version=variant.get("version", "NOT_VERSIONED"),
            engine_variant=variant.get("id", "default"),
            event_server_ip=args.event_server_ip,
            event_server_port=args.event_server_port,
            access_key=args.accesskey,
            feedback=args.feedback,
            server_key=args.server_key,
            log_url=args.log_url,
            log_prefix=args.log_prefix,
        ))
        print(f"Deploying on http://{args.ip}:{args.port} ...", flush=True)
        server.serve_forever(on_started=lambda port: print(
            f"Engine instance {server.engine_instance.id} deployed on "
            f"http://{args.ip}:{port} ({server.ctx.device})", flush=True))
        return 0

    if cmd == "undeploy":
        from incubator_predictionio_tpu_torch.servers.prediction_server import (
            undeploy,
        )

        if undeploy(args.ip, args.port, args.server_key):
            print("Undeployed.")
            return 0
        print("Nothing at the given address responded to /stop.")
        return 1

    if cmd == "eventserver":
        from incubator_predictionio_tpu_torch.servers.event_server import (
            EventServer,
            EventServerConfig,
        )

        conf_kw = {}
        if args.batch_cap is not None:
            conf_kw["max_batch"] = args.batch_cap
        server = EventServer(EventServerConfig(
            ip=args.ip, port=args.port, stats=args.stats, **conf_kw,
        ))
        _serve_until_signalled(
            server, f"Event Server running on http://{args.ip}:{{port}}")
        print("Event Server stopped.")
        return 0

    if cmd == "storageserver":
        from incubator_predictionio_tpu_torch.data.storage.server import (
            StorageServer,
        )

        server = StorageServer.from_env(
            source=args.source, host=args.ip, port=args.port,
            auth_key=args.auth_key)
        # announced after the bind with the port the kernel gave: with
        # `--port 0` a parent parses this line instead of racing others
        # for a pre-picked "free" port
        _serve_until_signalled(
            server, f"Storage Server running on http://{args.ip}:{{port}}")
        print("Storage Server stopped.")
        return 0

    if cmd == "adminserver":
        from incubator_predictionio_tpu_torch.servers.admin import AdminServer

        _serve_until_signalled(
            AdminServer(args.ip, args.port),
            f"Admin API running on http://{args.ip}:{{port}}")
        print("Admin API stopped.")
        return 0

    if cmd == "dashboard":
        from incubator_predictionio_tpu_torch.servers.dashboard import (
            DashboardServer,
        )

        _serve_until_signalled(
            DashboardServer(args.ip, args.port),
            f"Dashboard running on http://{args.ip}:{{port}}")
        print("Dashboard stopped.")
        return 0

    if cmd == "export":
        commands.export_events(args.app_name, args.output, args.channel,
                               format=args.format)
        return 0

    if cmd == "import":
        commands.import_events(args.app_name, args.input, args.channel,
                               format=args.format)
        return 0

    if cmd == "run":
        target = commands.resolve_engine_factory(args.main_class)
        result = target(*args.args) if callable(target) else None
        if result is not None:
            print(result)
        return 0

    if cmd == "template":
        print("The template command is deprecated; browse the template "
              "gallery instead (reference: commands/Template.scala:38-83).")
        return 0

    if cmd == "upgrade":
        results = commands.upgrade(args.app)
        if not results:
            print("Nothing to upgrade: the configured event backend has "
                  "no store-level migration/compaction (memory backend), "
                  "or no apps exist.")
            return 0
        for r in results:
            saved = r["bytes_before"] - r["bytes_after"]
            print(f"  app {r['app']} channel {r['channel']}: "
                  f"{r['events']} live events rewritten, "
                  f"{r['bytes_before']} -> {r['bytes_after']} bytes "
                  f"({saved:+d} reclaimed)")
        print("Upgrade complete: stores rewritten in the current format.")
        return 0

    print(f"Unknown command {cmd!r}")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    from incubator_predictionio_tpu_torch.utils.lease import (
        install_sigterm_exit,
    )

    # SIGTERM leaves through the interpreter (utils/lease.py); the server
    # verbs install their own graceful stop over it
    install_sigterm_exit()
    args = build_parser().parse_args(argv)
    try:
        return dispatch(args)
    except CommandError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
