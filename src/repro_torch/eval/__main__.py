import sys

from repro_torch.eval.cli import main

if __name__ == "__main__":
    sys.exit(main())
