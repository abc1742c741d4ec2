"""Command line of the port (counterpart of ddp_practice_tpu/cli.py).

    python -m ddp_practice_tpu_torch.cli serve [serve flags]

`serve` runs the serving benches on the card; serve/bench.py owns the
flags (the slot, static and, with `--paged`, paged rows; `--shared-prefix
[--kv-int8]`; `--spec-decode`). Training is a later slice of the port.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        from ddp_practice_tpu_torch.serve.bench import main as serve_main

        return serve_main(argv[1:])
    raise SystemExit(
        "usage: python -m ddp_practice_tpu_torch.cli serve [flags]; "
        "training is not ported yet"
    )


if __name__ == "__main__":
    raise SystemExit(main())
