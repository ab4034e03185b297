"""CLI: build the native radius search. ``python -m sgnn_tpu_torch.native.build``."""

import sys

from sgnn_tpu_torch import native


def main() -> int:
    if native.build(verbose=True) and native.available():
        print("built", native.library_path())
        return 0
    print("native build failed (cKDTree will be used)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
