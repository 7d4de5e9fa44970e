"""Entry point: ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout, on a machine
with the CUDA devices the workload asks for (see ``harness``)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
