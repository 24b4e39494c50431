# Copied from kyverno_tpu/cli/__main__.py, with the port's description.
"""CLI entry: python -m kyverno_tpu_torch.cli <command>.

Command surface mirrors cmd/cli/kubectl-kyverno/commands: apply, test,
jp, serve, version, json scan, fix, create, docs, oci.
"""

from __future__ import annotations

import argparse
import sys

from . import analyze as analyze_cmd
from . import apply as apply_cmd
from . import chainsaw as chainsaw_cmd
from . import flight as flight_cmd
from . import jp as jp_cmd
from . import lint as lint_cmd
from . import report as report_cmd
from . import serve as serve_cmd
from . import test as test_cmd
from . import tools as tools_cmd

VERSION = "0.4.0"


def _version(args) -> int:
    import os
    import subprocess

    # commands/version/command.go output shape. The commit comes from
    # the CLI's OWN checkout (git -C <package dir>), never from
    # whatever repository the user happens to run inside; installed
    # copies without git metadata report '---'.
    print(f"Version: {VERSION}")
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        commit = subprocess.run(
            ["git", "-C", pkg_dir, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5).stdout.strip()
    except Exception:
        commit = ""
    print("Time: ---")
    print(f"Git commit ID: {commit or '---'}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kyverno-tpu",
        description="Kyverno-equivalent policy CLI on a CUDA card "
                    "(the PyTorch port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    apply_cmd.add_parser(sub)
    analyze_cmd.add_parser(sub)
    lint_cmd.add_parser(sub)
    jp_cmd.add_parser(sub)
    test_cmd.add_parser(sub)
    serve_cmd.add_parser(sub)
    report_cmd.add_parser(sub)
    tools_cmd.add_parsers(sub)
    flight_cmd.add_parsers(sub)
    chainsaw_cmd.add_parser(sub)
    v = sub.add_parser("version", help="print version")
    v.set_defaults(func=_version)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
