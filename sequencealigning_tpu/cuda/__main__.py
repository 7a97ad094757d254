"""Build the CUDA fills ahead of first use: python -m sequencealigning_tpu.cuda"""

import time

from sequencealigning_tpu import cuda

t0 = time.perf_counter()
path = cuda.build()
print(f"{path} ({time.perf_counter() - t0:.1f} s)")
