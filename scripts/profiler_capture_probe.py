#!/usr/bin/env python3
"""How often a ``torch.profiler`` capture on the card loses kernels.

    python3 scripts/profiler_capture_probe.py [--procs 8] [--sessions 12]
        [--threads 2] [--seconds 0.4] [--caller threads|main]

Starts ``--procs`` processes side by side on one card. Each runs
``--threads`` threads that launch small matmuls without pause, then takes
``--sessions`` captures of ``--seconds`` each through the port's
``obs.profile.capture_trace``, from two caller threads in turn
(``--caller threads``, as a server's executor calls it) or all from the
process's main thread (``--caller main``). Prints
one JSON object a process: for each session its kernel events and kernel
launches, or ``"lost"`` with the capture's error where
``obs.profile.lost_kernels`` refused the trace. Then one summary line:
the processes that lost a session, the sessions lost, and the index of
each process's first loss. Needs a CUDA card.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(args) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from incubator_predictionio_tpu_torch.obs import profile

    a = torch.randn(256, 256, device="cuda")
    stop = threading.Event()

    def work():
        while not stop.is_set():
            (a @ a).sum().item()

    for _ in range(args.threads):
        threading.Thread(target=work, daemon=True).start()
    callers = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(2)]

    def capture(_i):
        try:
            out = profile.capture_trace(args.seconds, tempfile.mkdtemp())
        except RuntimeError as e:
            return {"lost": str(e).split(";")[0]}
        with open(os.path.join(out["traceDir"], profile.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        return {"kernels": sum(e.get("cat") == "kernel" for e in events),
                "launches": sum(e.get("cat") == "cuda_runtime"
                                and "LaunchKernel" in e.get("name", "")
                                for e in events)}

    if args.caller == "main":
        sessions = [capture(i) for i in range(args.sessions)]
    else:
        sessions = [callers[i % 2].submit(capture, i).result()
                    for i in range(args.sessions)]
    stop.set()
    print(json.dumps({"torch": torch.__version__, "sessions": sessions}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--sessions", type=int, default=12)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=0.4)
    ap.add_argument("--caller", choices=("threads", "main"),
                    default="threads")
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args)
        return 0
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--sessions", str(args.sessions), "--threads", str(args.threads),
           "--seconds", str(args.seconds), "--caller", args.caller]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
             for _ in range(args.procs)]
    first_lost, lost = [], 0
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            print(json.dumps({"rc": p.returncode}), flush=True)
            continue
        print(out.strip(), flush=True)
        sessions = json.loads(out.strip().splitlines()[-1])["sessions"]
        marks = [i for i, s in enumerate(sessions) if "lost" in s]
        lost += len(marks)
        first_lost.append(marks[0] if marks else None)
    print(json.dumps({"caller": args.caller, "processes": len(procs),
                      "processes_with_a_loss": sum(
                          m is not None for m in first_lost),
                      "sessions_lost": lost,
                      "sessions": args.sessions * len(procs),
                      "first_lost_session": first_lost}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
