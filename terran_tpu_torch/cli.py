"""``terran-tpu-torch`` console entry point: the checkpoint commands.

    python -m terran_tpu_torch.cli checkpoint list
    python -m terran_tpu_torch.cli checkpoint info <id>
    python -m terran_tpu_torch.cli checkpoint convert <id> <file.pth>
    python -m terran_tpu_torch.cli checkpoint download <id>
    python -m terran_tpu_torch.cli checkpoint delete <id>

The commands and their arguments are those of ``terran_tpu.cli``, over
``argparse`` instead of click. Usage errors exit with code 2, as click's do.
"""

import argparse
import sys
from pathlib import Path

from terran_tpu_torch import checkpoint


def build_parser():
    parser = argparse.ArgumentParser(prog="terran-tpu-torch")
    groups = parser.add_subparsers(dest="group", required=True)
    group = groups.add_parser("checkpoint",
                              help="Checkpoint management commands.")
    commands = group.add_subparsers(dest="command", required=True)
    commands.add_parser("list", help="List available checkpoints.")
    for name, help_text in (
            ("info", "Display detailed information on checkpoint."),
            ("delete", "Delete local files for a checkpoint."),
            ("download", "Download a remote checkpoint.")):
        commands.add_parser(name, help=help_text).add_argument(
            "checkpoint_id")
    convert = commands.add_parser(
        "convert",
        help="Convert a local torch .pth file into the checkpoint store.")
    convert.add_argument("checkpoint_id")
    convert.add_argument("pth_path")
    return parser


def main(argv=None):
    """Run one command; returns its exit code."""
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
        if args.command == "convert" and not Path(args.pth_path).exists():
            parser.error(f"argument pth_path: path '{args.pth_path}' does "
                         "not exist")
    except SystemExit as exc:
        return exc.code
    if args.command == "list":
        checkpoint.list_cmd()
    elif args.command == "convert":
        checkpoint.convert_cmd(args.checkpoint_id, args.pth_path)
    else:
        getattr(checkpoint, f"{args.command}_cmd")(args.checkpoint_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
