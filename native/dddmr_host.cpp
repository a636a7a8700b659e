// dddmr_host: native host-side runtime for dddmr_navigation_tpu.
//
// The reference stack's runtime is C++ end-to-end (rclcpp executors, PCL
// IO, FLANN trees, Channel<T> hand-offs). The JAX build keeps the compute
// path in XLA, but the host realtime shell around it is native too:
//
//   * binary PCD reading (the data-loader role of PCL's loadPCDFile —
//     reference: pcl::io::loadPCDFile everywhere, e.g. sub_maps.cpp:95)
//   * kNN/radius ground-graph construction over a uniform spatial hash
//     (the graph-builder role of StaticLayer::radiusSearchConnection /
//     nanoflann in the global planner) — map-load preprocessing that
//     feeds the padded (G, K) device tables
//   * a lock-free SPSC byte ring (the transport role of lego_loam's
//     Channel<T>, channel.h:11-60, and the DDS topic queues) for sensor
//     ingestion threads feeding the device tick loop
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the
// image). Build: native/build.sh (g++ -O3 -shared).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PCD IO
// ---------------------------------------------------------------------------

// Parse a PCD v0.7 header + binary/ascii payload. Returns number of
// points, or -1 on failure. On success *out is malloc'd (n * fields)
// float32, caller frees with dddmr_free. fields_out receives the column
// count.
long long pcd_read(const char* path, float** out, int* fields_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  long long n_points = 0;
  int fields = 0;
  std::vector<char> types;
  std::vector<int> sizes;
  std::vector<int> counts;
  bool binary = false;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (sscanf(line, "%63s", key) != 1) continue;
    if (!strcmp(key, "FIELDS")) {
      fields = 0;
      for (char* p = line + 6; *p; ++p)
        if (*p == ' ' && *(p + 1) && *(p + 1) != ' ' && *(p + 1) != '\n')
          fields++;
    } else if (!strcmp(key, "TYPE")) {
      types.clear();
      for (char* p = line; *p; ++p)
        if (*p == 'F' || *p == 'I' || *p == 'U') types.push_back(*p);
    } else if (!strcmp(key, "SIZE")) {
      sizes.clear();
      char* p = line + 4;
      int v;
      while (sscanf(p, "%d", &v) == 1) {
        sizes.push_back(v);
        while (*p == ' ') p++;
        while (*p && *p != ' ') p++;
      }
    } else if (!strcmp(key, "COUNT")) {
      counts.clear();
      char* p = line + 5;
      int v;
      while (sscanf(p, "%d", &v) == 1) {
        counts.push_back(v);
        while (*p == ' ') p++;
        while (*p && *p != ' ') p++;
      }
    } else if (!strcmp(key, "POINTS")) {
      sscanf(line, "POINTS %lld", &n_points);
    } else if (!strcmp(key, "DATA")) {
      binary = strstr(line, "binary") != nullptr;
      break;
    }
  }
  if (fields == 0 || n_points <= 0) { fclose(f); return -1; }
  if (types.empty()) types.assign(fields, 'F');
  if (sizes.empty()) sizes.assign(fields, 4);
  if (counts.empty()) counts.assign(fields, 1);
  int total_cols = 0;
  for (int c : counts) total_cols += c;

  float* buf = (float*)malloc(sizeof(float) * n_points * total_cols);
  if (!buf) { fclose(f); return -1; }

  if (binary) {
    int stride = 0;
    for (size_t i = 0; i < (size_t)fields; ++i) stride += sizes[i] * counts[i];
    std::vector<unsigned char> rec(stride);
    for (long long i = 0; i < n_points; ++i) {
      if (fread(rec.data(), 1, stride, f) != (size_t)stride) {
        free(buf); fclose(f); return -1;
      }
      int off = 0, col = 0;
      for (int fi = 0; fi < fields; ++fi) {
        for (int c = 0; c < counts[fi]; ++c) {
          float v = 0.f;
          if (types[fi] == 'F' && sizes[fi] == 4)
            memcpy(&v, rec.data() + off, 4);
          else if (types[fi] == 'F' && sizes[fi] == 8) {
            double d; memcpy(&d, rec.data() + off, 8); v = (float)d;
          } else if (types[fi] == 'I') {
            if (sizes[fi] == 4) { int32_t x; memcpy(&x, rec.data()+off, 4); v = (float)x; }
            else if (sizes[fi] == 2) { int16_t x; memcpy(&x, rec.data()+off, 2); v = (float)x; }
            else { int8_t x; memcpy(&x, rec.data()+off, 1); v = (float)x; }
          } else if (types[fi] == 'U') {
            if (sizes[fi] == 4) { uint32_t x; memcpy(&x, rec.data()+off, 4); v = (float)x; }
            else if (sizes[fi] == 2) { uint16_t x; memcpy(&x, rec.data()+off, 2); v = (float)x; }
            else { uint8_t x; memcpy(&x, rec.data()+off, 1); v = (float)x; }
          }
          buf[i * total_cols + col] = v;
          off += sizes[fi];
          col++;
        }
      }
    }
  } else {
    for (long long i = 0; i < n_points * total_cols; ++i) {
      double v;
      if (fscanf(f, "%lf", &v) != 1) { free(buf); fclose(f); return -1; }
      buf[i] = (float)v;
    }
  }
  fclose(f);
  *out = buf;
  *fields_out = total_cols;
  return n_points;
}

void dddmr_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// kNN ground-graph builder (uniform spatial hash)
// ---------------------------------------------------------------------------

// Build a padded neighbor table over 3D points: for each point, neighbors
// within `radius` (nearest-K of them), with kNN(orphan_k) fallback when
// fewer than orphan_k are found (a_star_on_pc.cpp:238-245 semantics).
// Outputs (caller-allocated): nbr_idx (g*k) int32 (-1 pad), nbr_dist
// (g*k) float32. Returns 0 on success.
int build_knn_graph(const float* pts, long long g, float radius, int k,
                    int orphan_k, int32_t* nbr_idx, float* nbr_dist) {
  if (g <= 0 || k <= 0) return -1;
  // bounding box
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (long long i = 0; i < g; ++i)
    for (int d = 0; d < 3; ++d) {
      float v = pts[i * 3 + d];
      if (v < mn[d]) mn[d] = v;
      if (v > mx[d]) mx[d] = v;
    }
  float cell = radius > 1e-6f ? radius : 0.5f;
  long long dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = (long long)((mx[d] - mn[d]) / cell) + 1;
    if (dims[d] < 1) dims[d] = 1;
    if (dims[d] > 4096) { cell = (mx[d] - mn[d]) / 4096.f + 1e-6f; d = -1; }
  }
  auto cell_of = [&](const float* p, long long* c) {
    for (int d = 0; d < 3; ++d) {
      long long v = (long long)((p[d] - mn[d]) / cell);
      if (v < 0) v = 0;
      if (v >= dims[d]) v = dims[d] - 1;
      c[d] = v;
    }
  };
  // counting sort into cells
  long long n_cells = dims[0] * dims[1] * dims[2];
  std::vector<int32_t> cell_start(n_cells + 1, 0);
  std::vector<int32_t> order(g);
  {
    std::vector<int32_t> cnt(n_cells, 0);
    std::vector<int64_t> cid(g);
    for (long long i = 0; i < g; ++i) {
      long long c[3];
      cell_of(pts + i * 3, c);
      cid[i] = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
      cnt[cid[i]]++;
    }
    for (long long i = 0; i < n_cells; ++i)
      cell_start[i + 1] = cell_start[i] + cnt[i];
    std::vector<int32_t> cur(cell_start.begin(), cell_start.end() - 1);
    for (long long i = 0; i < g; ++i) order[cur[cid[i]]++] = (int32_t)i;
  }

  float r2 = radius * radius;
  std::vector<std::pair<float, int32_t>> cand;
  for (long long i = 0; i < g; ++i) {
    const float* p = pts + i * 3;
    cand.clear();
    long long c[3];
    cell_of(p, c);
    int ring = 1;  // search expanding cell rings until enough neighbors
    while (true) {
      cand.clear();
      for (long long x = c[0] - ring; x <= c[0] + ring; ++x) {
        if (x < 0 || x >= dims[0]) continue;
        for (long long y = c[1] - ring; y <= c[1] + ring; ++y) {
          if (y < 0 || y >= dims[1]) continue;
          for (long long z = c[2] - ring; z <= c[2] + ring; ++z) {
            if (z < 0 || z >= dims[2]) continue;
            long long cc = (x * dims[1] + y) * dims[2] + z;
            for (int32_t s = cell_start[cc]; s < cell_start[cc + 1]; ++s) {
              int32_t j = order[s];
              if (j == (int32_t)i) continue;
              const float* q = pts + j * 3;
              float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
              float d2 = dx * dx + dy * dy + dz * dz;
              cand.emplace_back(d2, j);
            }
          }
        }
      }
      // enough in-radius neighbors, or enough for the orphan fallback,
      // or the ring already covers everything
      int in_r = 0;
      for (auto& pr : cand) in_r += pr.first <= r2 ? 1 : 0;
      bool covered = (2 * ring + 1) >= dims[0] && (2 * ring + 1) >= dims[1]
                     && (2 * ring + 1) >= dims[2];
      if (in_r >= orphan_k || (int)cand.size() >= orphan_k || covered) break;
      ring++;
    }
    std::sort(cand.begin(), cand.end());
    int written = 0;
    for (auto& pr : cand) {
      if (written >= k) break;
      bool in_radius = pr.first <= r2;
      if (!in_radius && written >= orphan_k) break;
      nbr_idx[i * k + written] = pr.second;
      nbr_dist[i * k + written] = std::sqrt(pr.first);
      written++;
    }
    for (; written < k; ++written) {
      nbr_idx[i * k + written] = -1;
      nbr_dist[i * k + written] = 0.f;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Lock-free SPSC byte ring (Channel<T> / DDS queue role)
// ---------------------------------------------------------------------------

struct SpscRing {
  std::atomic<uint64_t> head{0};  // consumer position
  std::atomic<uint64_t> tail{0};  // producer position
  uint64_t capacity{0};
  unsigned char* data{nullptr};
};

void* spsc_create(uint64_t capacity) {
  SpscRing* r = new SpscRing();
  r->capacity = capacity;
  r->data = (unsigned char*)malloc(capacity);
  if (!r->data) { delete r; return nullptr; }
  return r;
}

void spsc_destroy(void* ring) {
  SpscRing* r = (SpscRing*)ring;
  free(r->data);
  delete r;
}

// Push one length-prefixed message. Returns 1 on success, 0 when full.
int spsc_push(void* ring, const void* msg, uint32_t len) {
  SpscRing* r = (SpscRing*)ring;
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t need = 4ull + len;
  if (tail + need - head > r->capacity) return 0;
  for (int b = 0; b < 4; ++b)
    r->data[(tail + b) % r->capacity] = (len >> (8 * b)) & 0xff;
  const unsigned char* src = (const unsigned char*)msg;
  for (uint32_t b = 0; b < len; ++b)
    r->data[(tail + 4 + b) % r->capacity] = src[b];
  r->tail.store(tail + need, std::memory_order_release);
  return 1;
}

// Pop one message into out (cap bytes). Returns message length, 0 when
// empty, -1 when out is too small (message left in place).
long long spsc_pop(void* ring, void* out, uint32_t cap) {
  SpscRing* r = (SpscRing*)ring;
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  if (head == tail) return 0;
  uint32_t len = 0;
  for (int b = 0; b < 4; ++b)
    len |= ((uint32_t)r->data[(head + b) % r->capacity]) << (8 * b);
  if (len > cap) return -1;
  unsigned char* dst = (unsigned char*)out;
  for (uint32_t b = 0; b < len; ++b)
    dst[b] = r->data[(head + 4 + b) % r->capacity];
  r->head.store(head + 4ull + len, std::memory_order_release);
  return (long long)len;
}

uint64_t spsc_size(void* ring) {
  SpscRing* r = (SpscRing*)ring;
  return r->tail.load(std::memory_order_acquire)
       - r->head.load(std::memory_order_acquire);
}


// ---------------------------------------------------------------------------
// Realtime executor: drift-free periodic callback with native deadline
// accounting — the rclcpp timer/MultiThreadedExecutor role
// (`perception_3d_ros.cpp:220-249` sensorsUpdateLoop @10 Hz,
// `p2p_move_base.cpp:204-257` control loop @controller_frequency, both
// warn-on-overrun). The callback crosses into Python via ctypes (which
// acquires the GIL); pacing, jitter and overrun statistics stay native so
// a slow host interpreter cannot skew the measurement of itself.
// ---------------------------------------------------------------------------

typedef void (*dddmr_tick_cb)(void* user, long long tick_index);

struct RtExecutor {
  std::thread thread;
  std::atomic<bool> running{false};
  double period_s{0.1};
  dddmr_tick_cb cb{nullptr};
  void* user{nullptr};
  // stats
  std::atomic<long long> ticks{0};
  std::atomic<long long> misses{0};
  static const int kWindow = 1024;
  double durations_ms[kWindow];
  std::atomic<int> dur_count{0};
};

static void rt_executor_loop(RtExecutor* ex) {
  using clock = std::chrono::steady_clock;
  auto period = std::chrono::duration_cast<clock::duration>(
      std::chrono::duration<double>(ex->period_s));
  auto next = clock::now() + period;
  long long i = 0;
  while (ex->running.load(std::memory_order_acquire)) {
    auto t0 = clock::now();
    ex->cb(ex->user, i);
    auto t1 = clock::now();
    double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
    int slot = ex->dur_count.load(std::memory_order_relaxed);
    ex->durations_ms[slot % RtExecutor::kWindow] = ms;
    ex->dur_count.store(slot + 1, std::memory_order_relaxed);
    ex->ticks.fetch_add(1, std::memory_order_relaxed);
    if (ms > ex->period_s * 1e3)
      ex->misses.fetch_add(1, std::memory_order_relaxed);
    ++i;
    // drift-free absolute schedule; skip whole periods when overrun so a
    // long tick does not cause a burst of catch-up ticks
    auto now = clock::now();
    while (next <= now) next += period;
    std::this_thread::sleep_until(next);
    next += period;
  }
}

void* executor_create(double frequency_hz, dddmr_tick_cb cb, void* user) {
  RtExecutor* ex = new RtExecutor();
  ex->period_s = 1.0 / frequency_hz;
  ex->cb = cb;
  ex->user = user;
  return ex;
}

void executor_start(void* h) {
  RtExecutor* ex = (RtExecutor*)h;
  if (ex->running.exchange(true)) return;
  ex->thread = std::thread(rt_executor_loop, ex);
}

void executor_stop(void* h) {
  RtExecutor* ex = (RtExecutor*)h;
  if (!ex->running.exchange(false)) return;
  if (ex->thread.joinable()) ex->thread.join();
}

// out[6] = {ticks, misses, mean_ms, p50_ms, p99_ms, max_ms} over the last
// window of callback durations.
void executor_stats(void* h, double* out) {
  RtExecutor* ex = (RtExecutor*)h;
  int n = ex->dur_count.load(std::memory_order_relaxed);
  int m = n < RtExecutor::kWindow ? n : RtExecutor::kWindow;
  std::vector<double> d(ex->durations_ms, ex->durations_ms + m);
  std::sort(d.begin(), d.end());
  double mean = 0, mx = 0;
  for (double v : d) { mean += v; if (v > mx) mx = v; }
  out[0] = (double)ex->ticks.load();
  out[1] = (double)ex->misses.load();
  out[2] = m ? mean / m : 0.0;
  out[3] = m ? d[(int)(0.50 * (m - 1))] : 0.0;
  out[4] = m ? d[(int)(0.99 * (m - 1))] : 0.0;
  out[5] = mx;
}

void executor_destroy(void* h) {
  executor_stop(h);
  delete (RtExecutor*)h;
}

}  // extern "C"
