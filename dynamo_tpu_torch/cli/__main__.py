"""``python -m dynamo_tpu_torch.cli`` — the port's counterpart of
``python -m dynamo_tpu.cli`` (dynamo_tpu/cli/__main__.py:54-72). Only the
``run`` subcommand is ported (text, stdin, batch and an OpenAI HTTP server
over the local pipeline); the service launchers (worker, frontend, ...)
come with the distributed runtime (ROADMAP A4c).
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from dynamo_tpu_torch.cli.run import add_run_args, main_run


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        "dynamo-tpu-torch",
        description="the PyTorch/CUDA port's CLI: run an engine locally",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="drive a local engine (text/stdin/batch/http)")
    add_run_args(run_p)
    args = parser.parse_args(argv)
    if args.command == "run":
        asyncio.run(main_run(args))


if __name__ == "__main__":
    main()
