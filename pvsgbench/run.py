"""Run one cell of the benchmark once; see ``pvsgbench/core.py``.

    python3 pvsgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from pvsgbench import core

    sys.exit(core.main(sys.argv[1:]))
