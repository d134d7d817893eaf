"""Beyond-threshold sparse X on ONE device: the streaming chunked path.

Scattered-sparse matrices whose dense copy exceeds the densify threshold
have three single-device options in this build, demonstrated here on a
small problem by forcing each mode (none of them is timed on the GPU yet):

1. data_dtype='bfloat16' + sparse_mode='auto' — the threshold counts
   STORAGE bytes, so bf16 doubles the densify reach; the MU step then
   streams the dense bf16 matrix.
2. sparse_mode='chunked' — row-sorted COO chunks scatter into a reused
   ~256 MB dense buffer every iteration; X's dense form NEVER exists in
   device memory, so this is the only single-device option for X whose
   dense copy does not fit the device.
3. n_shards=K — row-shard so each device's local block densifies (see
   pod_scale_sharded.py).

Run: python examples/beyond_threshold_streaming.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.sparse as sp

from pycmf_tpu import CMF
from pycmf_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

rng = np.random.RandomState(0)
n, m, k = 5000, 3000, 16
density = 0.01
nnz = int(n * m * density)
X = sp.coo_matrix(
    (rng.rand(nnz), (rng.randint(0, n, nnz), rng.randint(0, m, nnz))),
    shape=(n, m)).tocsr()
Y = np.abs(rng.randn(m, 12))

print(f"X: {n}x{m}, {X.nnz} nnz ({X.nnz / (n * m):.2%} dense), "
      f"f32 copy {n * m * 4 / 2**20:.0f} MiB")

common = dict(n_components=k, solver="mu", max_iter=60, tol=1e-5,
              random_state=0)

# 1) storage-dtype densify: bf16 halves the dense footprint
model = CMF(data_dtype="bfloat16", sparse_mode="auto", **common)
U, V, Z = model.fit_transform(X, Y)
print(f"bf16 densify : {model.n_iter_} iters, "
      f"loss {model.reconstruction_err_:.6g}")

# 2) streaming chunked: forced here; 'auto' picks it only when even the
#    storage-dtype dense copy would blow the threshold
model_c = CMF(sparse_mode="chunked", **common)
Uc, Vc, Zc = model_c.fit_transform(X, Y)
print(f"chunked      : {model_c.n_iter_} iters, "
      f"loss {model_c.reconstruction_err_:.6g}")

# identical math, different layout — same objective
gap = abs(model.reconstruction_err_ - model_c.reconstruction_err_) \
    / model.reconstruction_err_
print(f"relative loss gap between the two layouts: {gap:.2e}")

# fold-in works through the chunked layout too
U_new = model_c.transform(X[:200])
print(f"transform fold-in on chunked model: {U_new.shape}")
