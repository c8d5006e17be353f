// L^-1 of an SPD matrix by Cholesky and forward substitution, by a block or
// by one warp.
//
// The recurrences of scenelib2_tpu/kernels/pallas_linalg.py::chol_linv_body:
// a right-looking factorisation with the factor stored transposed
// (U = L', inv_sqrt = 1 / sqrt(d), A -= dcol (drow / d)), then forward
// substitution L X = I with each row sum taken in ascending order. The
// plain PyTorch twin is scenelib2_torch/kernels/chol_inv.py::chol_linv; the
// operations run in the same order (built with -fmad=false).
//
// Two forms of the same operations on the same entries in the same order:
//   - chol_linv_block (every thread of the block calls it; K14 and K3 at
//     every M but CHOL_REG_M, K15): A [M][M] holds S on entry and is
//     overwritten, U and X are M x M of shared memory, X = L^-1 on return
//     (its upper triangle exact zeros); each step is one block-wide pass
//     between barriers;
//   - chol_linv_reg<M> (one warp, M known when compiled: CHOL_REG_M, which
//     the build sets to the M of the caller's matrices, kernels/chol_inv.py
//     reg_defines): lane l holds column l of A, of U and of X in registers,
//     every loop unrolled so that every register index is a constant, the
//     other columns' entries by __shfl_sync from their lanes; no shared
//     memory and no barrier; row j of X is formed as soon as step j has
//     made column j of U final, so the two chains overlap. One form for
//     every M <= 32 ran slower than a shared-memory warp form (PERF.md,
//     section 6): loops unrolled over 32 rows with the predicates j < M
//     and r < M, and the outer loops rolled with the inner ones unrolled
//     over 32; every even M compiled into one library took K3's nvcc from
//     13 to 41 s.
// Both are bound by latency, the M dependent steps (PERF.md, section 6).
#pragma once

__device__ inline void chol_linv_block(float* A, float* U, float* X, int M) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // ---- Cholesky, right-looking, factor stored transposed
  for (int j = 0; j < M; ++j) {
    const float d = A[j * M + j];
    const float inv_sqrt = 1.0f / sqrtf(d);
    for (int l = j + tid; l < M; l += nt) U[j * M + l] = A[j * M + l] * inv_sqrt;
    const int nb = M - 1 - j;
    for (int e = tid; e < nb * nb; e += nt) {
      const int r = j + 1 + e / nb, l = j + 1 + e % nb;
      A[r * M + l] = A[r * M + l] - A[r * M + j] * (A[j * M + l] / d);
    }
    __syncthreads();
  }
  // ---- X = L^-1 by forward substitution, row sums ascending
  for (int i = 0; i < M; ++i) {
    for (int l = tid; l < M; l += nt) {
      float contrib = 0.0f;
      if (i > 0) {
        contrib = U[i] * X[l];  // U[0][i] * X[0][l]
        for (int r = 1; r < i; ++r) contrib = contrib + U[r * M + i] * X[r * M + l];
      }
      X[i * M + l] = ((i == l ? 1.0f : 0.0f) - contrib) / U[i * M + i];
    }
    __syncthreads();
  }
}

// one warp in its registers, M known when compiled (the caller's lanes
// 0..31 all call it): A [M][M] (S, read once, left as it is) and X [M][M]
// (L^-1) in shared or global memory
template <int M>
__device__ __forceinline__ void chol_linv_reg(const float* A, float* X) {
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31;
  // c[r]: A[r][l], the trailing matrix's column l; from step r on, U[r][l]
  // (row r of column l is read last at step r); xc[i]: X[i][l]
  float c[M], xc[M];
#pragma unroll
  for (int r = 0; r < M; ++r) c[r] = l < M ? A[r * M + l] : 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    // ---- Cholesky step j, right-looking, factor stored transposed
    const float d = __shfl_sync(full, c[j], j);  // A[j][j]
    const float inv_sqrt = 1.0f / sqrtf(d);
    const float q = c[j] / d;                     // the block form's (A[j][l] / d), the same quotient
#pragma unroll
    for (int r = j + 1; r < M; ++r) {
      const float arj = __shfl_sync(full, c[r], j);  // A[r][j]
      if (l > j) c[r] = c[r] - arj * q;
    }
    c[j] = c[j] * inv_sqrt;  // U[j][l], read where l >= j
    // ---- row j of X = L^-1, its sum ascending: U[r][j] (r <= j) from lane j
    float contrib = 0.0f;
    if (j > 0) {
      contrib = __shfl_sync(full, c[0], j) * xc[0];  // U[0][j] * X[0][l]
#pragma unroll
      for (int r = 1; r < j; ++r) contrib = contrib + __shfl_sync(full, c[r], j) * xc[r];
    }
    xc[j] = ((j == l ? 1.0f : 0.0f) - contrib) / __shfl_sync(full, c[j], j);
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (l < M) X[i * M + l] = xc[i];
  __syncwarp();
}

#ifdef CHOL_REG_M
static_assert(CHOL_REG_M >= 1 && CHOL_REG_M <= 32, "CHOL_REG_M: the register form takes M <= 32");
#endif

// whether M has a register form in this build (the host's choice of K14's
// kernel, K3's choice of warp 0)
__host__ __device__ inline bool chol_linv_reg_sized(int M) {
#ifdef CHOL_REG_M
  return M == CHOL_REG_M;
#else
  return false;
#endif
}

// chol_linv_reg<M>(A, X) where chol_linv_reg_sized(M) (the caller's lanes
// 0..31 all call it), else nothing
__device__ inline void chol_linv_reg_any(const float* A, float* X, int M) {
#ifdef CHOL_REG_M
  if (M == CHOL_REG_M) chol_linv_reg<CHOL_REG_M>(A, X);
#endif
}
