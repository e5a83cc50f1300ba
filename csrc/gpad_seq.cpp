// Native sequential GPAD step library.
//
// Functional equivalent of the reference's CPU baseline
// (Code/CUDA/FinalProject/src/seq_functions.cpp — StepOne..StepFour dense
// variants) rebuilt for this framework: float32, row-major, canonical
// (MATLAB/paper) sign convention zhat = -M_G w - g_P, plus a full
// fixed-budget solve loop (acceldualgrad.m:39-64) and a paired half-stack
// solve matching the JAX solver's layout. Exposed with C linkage for ctypes.
//
// Role in the oracle hierarchy (SURVEY.md section 4): the fast host-side
// ground truth for parity tests and the CPU baseline the benchmark's
// vs_baseline speedup is measured against.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Step 1 (SAXPY): w = y + beta * (y - y_prev)
void gpad_step1(const float* y, const float* y_prev, float beta, float* w,
                int64_t m) {
  for (int64_t i = 0; i < m; ++i) w[i] = y[i] + beta * (y[i] - y_prev[i]);
}

// Step 2 (MVP): zhat = sign * (M_G^T w) - g_P, with M_G stored as MG_T
// (m x n_z, row-major): zhat[j] = sign * sum_i w[i] * MG_T[i, j] - g_P[j].
// sign = -1 for the canonical convention, +1 for the reference CUDA
// convention against a pre-negated matrix (kernel_functions.cu:62).
void gpad_step2(const float* MG_T, const float* w, const float* g_P,
                float* zhat, int64_t m, int64_t n_z, float sign) {
  for (int64_t j = 0; j < n_z; ++j) zhat[j] = 0.0f;
  for (int64_t i = 0; i < m; ++i) {
    const float wi = w[i];
    const float* row = MG_T + i * n_z;
    for (int64_t j = 0; j < n_z; ++j) zhat[j] += wi * row[j];
  }
  for (int64_t j = 0; j < n_z; ++j) zhat[j] = sign * zhat[j] - g_P[j];
}

// Step 3: z = (1 - theta) z + theta zhat
void gpad_step3(float* z, const float* zhat, float theta, int64_t n_z) {
  for (int64_t j = 0; j < n_z; ++j)
    z[j] = (1.0f - theta) * z[j] + theta * zhat[j];
}

// Step 4 (MVP + projection): y_next = max(w + GL_T^T zhat + p_D, 0) with
// GL_T stored (n_z x m, row-major): y_next[i] = max(w[i] + sum_j zhat[j] *
// GL_T[j, i] + p_D[i], 0). Branchless like kernel_functions.cu:195.
void gpad_step4(const float* GL_T, const float* w, const float* p_D,
                const float* zhat, float* y_next, int64_t m, int64_t n_z) {
  for (int64_t i = 0; i < m; ++i) y_next[i] = w[i] + p_D[i];
  for (int64_t j = 0; j < n_z; ++j) {
    const float zj = zhat[j];
    const float* row = GL_T + j * m;
    for (int64_t i = 0; i < m; ++i) y_next[i] += zj * row[i];
  }
  for (int64_t i = 0; i < m; ++i)
    y_next[i] = 0.5f * (y_next[i] + std::abs(y_next[i]));
}

// Full fixed-budget GPAD solve (acceldualgrad.m:39-64 / main.cu:160-175).
// Outputs the final primal iterate z (n_z) and dual iterate y (m).
// Workspaces are allocated on the stack of the caller via the out buffers:
// scratch must hold 3*m + n_z floats (y, y_prev, w | zhat).
void gpad_solve_fixed(const float* MG_T, const float* GL_T, const float* g_P,
                      const float* p_D, const float* theta, const float* beta,
                      int64_t m, int64_t n_z, int64_t iterations, float sign,
                      float* z_out, float* y_out, float* scratch) {
  float* y = scratch;
  float* y_prev = scratch + m;
  float* w = scratch + 2 * m;
  float* zhat = scratch + 3 * m;
  std::memset(y, 0, sizeof(float) * m);
  std::memset(y_prev, 0, sizeof(float) * m);
  std::memset(z_out, 0, sizeof(float) * n_z);
  for (int64_t k = 0; k < iterations; ++k) {
    gpad_step1(y, y_prev, beta[k], w, m);
    gpad_step2(MG_T, w, g_P, zhat, m, n_z, sign);
    gpad_step3(z_out, zhat, theta[k], n_z);
    // register shift BEFORE y is overwritten (acceldualgrad.m:59-64)
    std::memcpy(y_prev, y, sizeof(float) * m);
    gpad_step4(GL_T, w, p_D, zhat, y, m, n_z);
  }
  std::memcpy(y_out, y, sizeof(float) * m);
}

// Paired half-stack solve (the JAX solver's layout, GPADData docs):
// MG_T is (m_h x n_z), GL_T is (n_z x m_h), p_D is (2 x m_h) [plus; minus],
// y/w are (2 x m_h). Step 2 contracts (w+ - w-); step 4 computes
// q = GL_T^T zhat once and projects both sign applications.
// scratch must hold 6*m_h + n_z + m_h floats.
void gpad_solve_fixed_paired(const float* MG_T, const float* GL_T,
                             const float* g_P, const float* p_D,
                             const float* theta, const float* beta,
                             int64_t m_h, int64_t n_z, int64_t iterations,
                             float* z_out, float* y_out, float* scratch) {
  float* y = scratch;              // (2, m_h)
  float* y_prev = scratch + 2 * m_h;
  float* w = scratch + 4 * m_h;    // (2, m_h)
  float* zhat = scratch + 6 * m_h; // (n_z)
  float* wd = scratch + 6 * m_h + n_z;  // (m_h)
  std::memset(y, 0, sizeof(float) * 2 * m_h);
  std::memset(y_prev, 0, sizeof(float) * 2 * m_h);
  std::memset(z_out, 0, sizeof(float) * n_z);
  for (int64_t k = 0; k < iterations; ++k) {
    gpad_step1(y, y_prev, beta[k], w, 2 * m_h);
    for (int64_t i = 0; i < m_h; ++i) wd[i] = w[i] - w[m_h + i];
    gpad_step2(MG_T, wd, g_P, zhat, m_h, n_z, -1.0f);
    gpad_step3(z_out, zhat, theta[k], n_z);
    std::memcpy(y_prev, y, sizeof(float) * 2 * m_h);
    // q = GL_T^T zhat, applied with both signs
    for (int64_t i = 0; i < m_h; ++i) {
      float q = 0.0f;
      for (int64_t j = 0; j < n_z; ++j) q += zhat[j] * GL_T[j * m_h + i];
      const float vp = w[i] + q + p_D[i];
      const float vm = w[m_h + i] - q + p_D[m_h + i];
      y[i] = 0.5f * (vp + std::abs(vp));
      y[m_h + i] = 0.5f * (vm + std::abs(vm));
    }
  }
  std::memcpy(y_out, y, sizeof(float) * 2 * m_h);
}

// Flat paired solve: the structure-exploiting variant (the reference's
// flat kernels, seq_functions.cpp:5-43 / kernel_functions.cu:74-109, done
// for THIS framework's flat layout). Half-stack rows are ordered
// [struct (n_s) | input-box (n_z)] with the box rows EXACTLY the identity
// (GPADData.n_struct): step 4's box rows cost w +- zhat/L + p_D with no
// matmul, and only the (n_z x n_s) structured block multiplies.
// GLs_T is GL_T's structured columns, (n_z x n_s) row-major.
// scratch layout identical to gpad_solve_fixed_paired (m_h = n_s + n_z).
void gpad_solve_fixed_paired_flat(const float* MG_T, const float* GLs_T,
                                  const float* g_P, const float* p_D,
                                  const float* theta, const float* beta,
                                  float inv_L, int64_t n_s, int64_t n_z,
                                  int64_t iterations, float* z_out,
                                  float* y_out, float* scratch) {
  const int64_t m_h = n_s + n_z;
  float* y = scratch;              // (2, m_h)
  float* y_prev = scratch + 2 * m_h;
  float* w = scratch + 4 * m_h;    // (2, m_h)
  float* zhat = scratch + 6 * m_h; // (n_z)
  float* wd = scratch + 6 * m_h + n_z;  // (m_h)
  std::memset(y, 0, sizeof(float) * 2 * m_h);
  std::memset(y_prev, 0, sizeof(float) * 2 * m_h);
  std::memset(z_out, 0, sizeof(float) * n_z);
  for (int64_t k = 0; k < iterations; ++k) {
    gpad_step1(y, y_prev, beta[k], w, 2 * m_h);
    for (int64_t i = 0; i < m_h; ++i) wd[i] = w[i] - w[m_h + i];
    gpad_step2(MG_T, wd, g_P, zhat, m_h, n_z, -1.0f);
    gpad_step3(z_out, zhat, theta[k], n_z);
    std::memcpy(y_prev, y, sizeof(float) * 2 * m_h);
    // structured rows: the only matmul of step 4
    for (int64_t i = 0; i < n_s; ++i) {
      float q = 0.0f;
      for (int64_t j = 0; j < n_z; ++j) q += zhat[j] * GLs_T[j * n_s + i];
      const float vp = w[i] + q + p_D[i];
      const float vm = w[m_h + i] - q + p_D[m_h + i];
      y[i] = 0.5f * (vp + std::abs(vp));
      y[m_h + i] = 0.5f * (vm + std::abs(vm));
    }
    // identity-block rows: q is just zhat / L (no flops beyond the add)
    for (int64_t j = 0; j < n_z; ++j) {
      const int64_t i = n_s + j;
      const float q = zhat[j] * inv_L;
      const float vp = w[i] + q + p_D[i];
      const float vm = w[m_h + i] - q + p_D[m_h + i];
      y[i] = 0.5f * (vp + std::abs(vp));
      y[m_h + i] = 0.5f * (vm + std::abs(vm));
    }
  }
  std::memcpy(y_out, y, sizeof(float) * 2 * m_h);
}

// Stage-wise (non-condensed) fixed-budget GPAD solve: the CPU baseline
// for the O(N) engine (tpu_gpad/stagewise.py `_solve_one`; the variant
// the reference's seq library has no analogue for — nmpc12-gpad.pdf p.3).
// Per iteration: stage-local dual extrapolation, one backward affine
// Riccati sweep (precomputed gains), one forward rollout, primal
// averaging and the projected dual ascent. All row-major float32.
//
// Shapes: A_seq/E (N,n,n), B_seq (N,n,p), K (N,p,n), Hi (N,p,p),
// Gx (m_x,n), hx (N,m_x), Gu (m_u,p), hu (N,m_u), dtl/qoff/c_seq (N,n),
// theta/beta (iterations), x0 (n). Outputs: zu_out (N,p) averaged input
// plan, y_out (N, m_x+m_u) stage-packed dual, diag_out[0/1] residual/gap.
// scratch: N*(2*(m_x+m_u) + 3*n + 2*p) + 2*n + 2*p floats.
void gpad_solve_stagewise_fixed(
    const float* A_seq, const float* B_seq, const float* K, const float* Hi,
    const float* E, const float* Gx, const float* hx, const float* Gu,
    const float* hu, const float* dtl, const float* qoff, const float* c_seq,
    const float* theta, const float* beta, float inv_L, int64_t N, int64_t n,
    int64_t p, int64_t m_x, int64_t m_u, int64_t iterations, const float* x0,
    float* zu_out, float* y_out, float* diag_out, float* scratch) {
  const int64_t ms = m_x + m_u;
  float* y = scratch;                    // (N, ms) packed [yx | yu]
  float* y_prev = y + N * ms;            // (N, ms)
  float* qx = y_prev + N * ms;           // (N, n)
  float* ru = qx + N * n;                // (N, p)
  float* st = ru + N * p;                // (N, n) stilde
  float* zx = st + N * n;                // (N, n) averaged states
  float* zu = zx + N * n;                // (N, p) averaged inputs
  float* x = zu + N * p;                 // (n)
  float* xn = x + n;                     // (n)
  float* kff = xn + n;                   // (p)
  float* u = kff + p;                    // (p)
  std::memset(y, 0, sizeof(float) * 2 * N * ms);
  std::memset(zx, 0, sizeof(float) * N * n);
  std::memset(zu, 0, sizeof(float) * N * p);
  std::memset(zu_out, 0, sizeof(float) * N * p);
  for (int64_t it = 0; it < iterations; ++it) {
    const float b = beta[it];
    const float th = theta[it];
    // w = y + b (y - y_prev), stored IN y_out as stage-packed w; qx/ru
    // from the stage-local constraint transposes, plus the qoff shift
    for (int64_t k = 0; k < N; ++k) {
      float* wk = y_out + k * ms;  // reuse y_out as the w workspace
      const float* yk = y + k * ms;
      const float* ypk = y_prev + k * ms;
      for (int64_t i = 0; i < ms; ++i)
        wk[i] = yk[i] + b * (yk[i] - ypk[i]);
      float* qk = qx + k * n;
      for (int64_t j = 0; j < n; ++j) qk[j] = qoff[k * n + j];
      for (int64_t i = 0; i < m_x; ++i) {
        const float wi = wk[i];
        const float* row = Gx + i * n;
        for (int64_t j = 0; j < n; ++j) qk[j] += wi * row[j];
      }
      float* rk = ru + k * p;
      for (int64_t j = 0; j < p; ++j) rk[j] = 0.0f;
      for (int64_t i = 0; i < m_u; ++i) {
        const float wi = wk[m_x + i];
        const float* row = Gu + i * p;
        for (int64_t j = 0; j < p; ++j) rk[j] += wi * row[j];
      }
    }
    // backward sweep: st[k] = s_{k+1} = qx[k] + E[k+1]' s - K[k+1]' ru[k+1]
    for (int64_t j = 0; j < n; ++j) st[(N - 1) * n + j] = qx[(N - 1) * n + j];
    for (int64_t k = N - 2; k >= 0; --k) {
      const float* s_next = st + (k + 1) * n;
      const float* Ek1 = E + (k + 1) * n * n;
      const float* Kk1 = K + (k + 1) * p * n;
      const float* rk1 = ru + (k + 1) * p;
      float* sk = st + k * n;
      for (int64_t j = 0; j < n; ++j) {
        float acc = qx[k * n + j];
        for (int64_t i = 0; i < n; ++i) acc += Ek1[i * n + j] * s_next[i];
        for (int64_t i = 0; i < p; ++i) acc -= Kk1[i * n + j] * rk1[i];
        sk[j] = acc;
      }
    }
    // forward rollout + primal averaging + projected dual ascent
    std::memcpy(x, x0, sizeof(float) * n);
    for (int64_t k = 0; k < N; ++k) {
      const float* Ak = A_seq + k * n * n;
      const float* Bk = B_seq + k * n * p;
      const float* Kk = K + k * p * n;
      const float* Hik = Hi + k * p * p;
      const float* sk = st + k * n;
      const float* rk = ru + k * p;
      // kff = Hi (B' (stilde + dtl) + ru)
      for (int64_t i = 0; i < p; ++i) {
        float acc = rk[i];
        for (int64_t j = 0; j < n; ++j)
          acc += Bk[j * p + i] * (sk[j] + dtl[k * n + j]);
        u[i] = acc;  // temp: B' st + ru
      }
      for (int64_t i = 0; i < p; ++i) {
        float acc = 0.0f;
        for (int64_t j = 0; j < p; ++j) acc += Hik[i * p + j] * u[j];
        kff[i] = acc;
      }
      for (int64_t i = 0; i < p; ++i) {
        float acc = -kff[i];
        for (int64_t j = 0; j < n; ++j) acc -= Kk[i * n + j] * x[j];
        kff[i] = acc;  // now kff holds u_k
      }
      for (int64_t j = 0; j < n; ++j) {
        float acc = c_seq[k * n + j];
        for (int64_t i = 0; i < n; ++i) acc += Ak[j * n + i] * x[i];
        for (int64_t i = 0; i < p; ++i) acc += Bk[j * p + i] * kff[i];
        xn[j] = acc;
      }
      std::memcpy(x, xn, sizeof(float) * n);
      for (int64_t i = 0; i < p; ++i)
        zu[k * p + i] = (1.0f - th) * zu[k * p + i] + th * kff[i];
      for (int64_t j = 0; j < n; ++j)
        zx[k * n + j] = (1.0f - th) * zx[k * n + j] + th * xn[j];
      // dual ascent on this stage's rows (w lives in y_out)
      float* wk = y_out + k * ms;
      float* yk = y + k * ms;
      float* ypk = y_prev + k * ms;
      std::memcpy(ypk, yk, sizeof(float) * ms);
      for (int64_t i = 0; i < m_x; ++i) {
        float g = -hx[k * m_x + i];
        const float* row = Gx + i * n;
        for (int64_t j = 0; j < n; ++j) g += row[j] * xn[j];
        const float v = wk[i] + inv_L * g;
        yk[i] = 0.5f * (v + std::abs(v));
      }
      for (int64_t i = 0; i < m_u; ++i) {
        float g = -hu[k * m_u + i];
        const float* row = Gu + i * p;
        for (int64_t j = 0; j < p; ++j) g += row[j] * kff[j];
        const float v = wk[m_x + i] + inv_L * g;
        yk[m_x + i] = 0.5f * (v + std::abs(v));
      }
    }
  }
  // epilogue: clamped max violation + gap of the averaged primal (the
  // averaged states are the exact rollout of zu — x linear in u)
  float vmax = -1e30f;
  float gap = 0.0f;
  std::memcpy(x, x0, sizeof(float) * n);
  for (int64_t k = 0; k < N; ++k) {
    const float* Ak = A_seq + k * n * n;
    const float* Bk = B_seq + k * n * p;
    for (int64_t j = 0; j < n; ++j) {
      float acc = c_seq[k * n + j];
      for (int64_t i = 0; i < n; ++i) acc += Ak[j * n + i] * x[i];
      for (int64_t i = 0; i < p; ++i) acc += Bk[j * p + i] * zu[k * p + i];
      xn[j] = acc;
    }
    std::memcpy(x, xn, sizeof(float) * n);
    const float* yk = y + k * ms;
    for (int64_t i = 0; i < m_x; ++i) {
      float g = -hx[k * m_x + i];
      const float* row = Gx + i * n;
      for (int64_t j = 0; j < n; ++j) g += row[j] * xn[j];
      vmax = std::max(vmax, g);
      gap += yk[i] * g;
    }
    for (int64_t i = 0; i < m_u; ++i) {
      float g = -hu[k * m_u + i];
      const float* row = Gu + i * p;
      for (int64_t j = 0; j < p; ++j) g += row[j] * zu[k * p + j];
      vmax = std::max(vmax, g);
      gap += yk[m_x + i] * g;
    }
  }
  std::memcpy(zu_out, zu, sizeof(float) * N * p);
  std::memcpy(y_out, y, sizeof(float) * N * ms);
  diag_out[0] = std::max(vmax, 0.0f);
  diag_out[1] = -gap;
}

// Batched dense solve: B independent scenarios sharing MG_T/GL_T with
// per-scenario g_P (B x n_z) and p_D (B x m). The multi-scenario CPU
// baseline for throughput comparisons.
void gpad_solve_fixed_batch(const float* MG_T, const float* GL_T,
                            const float* g_P, const float* p_D,
                            const float* theta, const float* beta, int64_t B,
                            int64_t m, int64_t n_z, int64_t iterations,
                            float sign, float* z_out, float* y_out,
                            float* scratch) {
  for (int64_t b = 0; b < B; ++b) {
    gpad_solve_fixed(MG_T, GL_T, g_P + b * n_z, p_D + b * m, theta, beta, m,
                     n_z, iterations, sign, z_out + b * n_z, y_out + b * m,
                     scratch);
  }
}

}  // extern "C"
