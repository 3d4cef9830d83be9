"""The benchmark of kallisto_tpu_torch on an NVIDIA card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Re-executes itself once under the allocator settings that
`python -m kallisto_tpu_torch.cli` gives itself and with a fixed
PYTHONHASHSEED (the same hashing, so the same work, in every process),
then runs one cell
(kbench/harness.py) and prints its result as the last line of standard
output.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

from kbench import harness  # noqa: E402

if __name__ == "__main__":
    env = dict(harness.cli_malloc_env(os.path.join(ROOT, "kallisto_tpu_torch")),
               PYTHONHASHSEED="0")
    if any(os.environ.get(k) != v for k, v in env.items()):
        os.environ.update(env)
        os.execv(sys.executable, [sys.executable] + sys.argv)
    sys.exit(harness.main())
