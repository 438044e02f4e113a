"""Run one cell of the benchmark of ``cg_raytracer_tpu_torch``:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the result (JSON).
"""
import os
import sys
import time

T_START = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
# Python's bytecode is a build cache too: kept inside the checkout, at a fixed
# path, so that only a checkout's first run compiles the modules it imports
# (where the environment writes no bytecode, every run would).
sys.pycache_prefix = os.path.join(os.path.dirname(HERE), ".benchcache", "pycache")
sys.dont_write_bytecode = False

from rtbench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
