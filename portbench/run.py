"""Run one cell of the benchmark of ``cuembed_tpu_torch`` on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
as one JSON object; the numbers that decide ``correct`` end standard error.
"""

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from portbench.harness import main

    sys.exit(main())
