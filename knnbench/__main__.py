"""``python3 -m knnbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``"""

import time

# set-up counts from here, before torch and the program are imported
_T_MAIN = time.perf_counter()

import sys  # noqa: E402

from knnbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_main=_T_MAIN))
