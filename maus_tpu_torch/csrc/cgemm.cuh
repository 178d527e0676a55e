// C entries of kernel K3 (csrc/cgemm.cu, csrc/cgemm_tc.cu), declared once so
// that every source that defines or calls one is checked against it.
#pragma once

// C = beta·C + alpha·A·B, batched: complex64 (is_c128 = 0) on the tensor
// cores, complex128 on the CUDA cores.
extern "C" int maus_cgemm(const void* A, const void* B, void* C, int is_c128,
                          int batch, int M, int N, int K, long long lda,
                          long long ldb, long long ldc, long long sA,
                          long long sB, long long sC, double alpha_re,
                          double alpha_im, double beta_re, double beta_im,
                          void* stream);

// The complex64 tensor-core kernel; 16-byte copies where the pointers and
// strides allow, else 8-byte ones.
extern "C" int maus_cgemm_tc(const void* A, const void* B, void* C, int batch, int M,
                             int N, int K, long long lda, long long ldb, long long ldc,
                             long long sA, long long sB, long long sC, double alpha_re,
                             double alpha_im, double beta_re, double beta_im,
                             void* stream);
