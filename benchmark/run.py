"""Entry point of the benchmark; see ``benchmark/harness.py``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
