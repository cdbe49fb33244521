"""``python -m dynamo_tpu_torch.cli`` — the port's counterpart of
``python -m dynamo_tpu.cli`` (dynamo_tpu/cli/__main__.py):

- ``worker``, ``frontend`` and ``discd`` re-exec the port's service mains,
  so that ``python -m dynamo_tpu_torch.cli worker --model tiny`` is
  ``python -m dynamo_tpu_torch.worker --model tiny`` (JAX's other services
  wait for their ROADMAP items);
- ``run`` drives a local engine (text, stdin, batch, or an OpenAI HTTP
  server over the local pipeline);
- ``observe`` (the device plane: memory, compiles, flight),
  ``observe trajectory``, ``observe kvcache`` and ``observe perf``
  pretty-print a running worker's system server;
- ``env`` prints the environment knobs the port reads.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from dynamo_tpu_torch import config
from dynamo_tpu_torch.cli.run import add_observe_args, add_run_args, main_observe, main_run

# The service mains the port has (dynamo_tpu/deploy/spec.py KIND_MODULES).
SERVICES = {
    "frontend": "dynamo_tpu_torch.frontend",
    "worker": "dynamo_tpu_torch.worker",
    "discd": "dynamo_tpu_torch.discd",
}


def cmd_env() -> None:
    """Print the DYN_TPU_* knobs the port reads, as JAX's ``env`` prints
    its registry: name, default, the value set in the environment, doc."""
    knobs = sorted((v.name, v) for v in vars(config).values() if isinstance(v, config.EnvVar))
    width = max(len(n) for n, _ in knobs)
    for name, var in knobs:
        current = os.environ.get(name)
        state = f" [set: {current}]" if current is not None else ""
        print(f"{name:<{width}}  default={var.default!r}{state}")
        if var.doc:
            print(f"{'':<{width}}  {var.doc}")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SERVICES:
        module = SERVICES[argv[0]]
        sys.argv = [module] + argv[1:]
        import runpy

        runpy.run_module(module, run_name="__main__")
        return
    parser = argparse.ArgumentParser(
        "dynamo-tpu-torch",
        description="the PyTorch/CUDA port's CLI: run an engine locally, observe a "
        f"worker, inspect config, or launch services ({', '.join(SERVICES)})",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="drive a local engine (text/stdin/batch/http)")
    add_run_args(run_p)
    observe_p = sub.add_parser(
        "observe", help="pretty-print a running worker's system server: the "
        "device plane, or the trajectory, kvcache and perf views")
    add_observe_args(observe_p)
    sub.add_parser("env", help="print the environment knobs the port reads")
    args = parser.parse_args(argv)
    if args.command == "env":
        cmd_env()
    elif args.command == "run":
        asyncio.run(main_run(args))
    elif args.command == "observe":
        main_observe(args)


if __name__ == "__main__":
    main()
