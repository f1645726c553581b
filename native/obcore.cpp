// Native host-runtime core for the TSD-SLAM framework.
//
// C++ equivalent of the reference's host-side infrastructure layers:
//   * the thread-synchronization surface of ThreadSLAM / ThreadLocalize /
//     ThreadMapping (src/ThreadSLAM.{h,cpp}: condition-variable
//     sleep/unblock; src/ThreadLocalize.cpp:269-332: mutex-guarded
//     latest-wins scan slot; src/ThreadMapping.cpp:43-76: mutex-guarded
//     LIFO-drained work queue) — here as generic byte-payload channels
//     with two policies: MAILBOX (latest wins) and STACK (newest-first
//     drain, bounded);
//   * obcore/base/Timer (src/obcore/base/Timer.{h,cpp}) — monotonic
//     clock with elapsed/reset;
//   * obcore/base/Logger (src/obcore/base/Logger.{h,cpp}) — leveled
//     logging to screen and/or file;
//   * obcore/base/tools PPM/PGM serializers
//     (src/obcore/base/tools.{h,cpp}).
//
// The device compute path stays in JAX/XLA; this library provides the
// native runtime around it, exposed through a plain C ABI for ctypes.
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC).

#include <chrono>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Channels: MAILBOX (latest-wins) and STACK (newest-first, bounded)
// ---------------------------------------------------------------------------

enum ChannelPolicy {
  CHANNEL_MAILBOX = 0,  // keep only the newest item (ThreadLocalize scans)
  CHANNEL_STACK = 1,    // drain newest-first, keep up to capacity items
};

struct Channel {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> items;
  int policy = CHANNEL_MAILBOX;
  size_t capacity = 64;
  uint64_t pushed = 0;
  uint64_t dropped = 0;
  bool closed = false;
};

void* channel_new(int policy, size_t capacity) {
  Channel* c = new Channel();
  c->policy = policy;
  c->capacity = capacity > 0 ? capacity : 1;
  return c;
}

void channel_free(void* h) { delete static_cast<Channel*>(h); }

// Push a payload. MAILBOX: replaces any pending item (the reference's
// keep-newest deque, ThreadLocalize.cpp:321-331). STACK: appends; when
// over capacity the OLDEST entry is dropped (newest data wins, matching
// the real-time intent of the newest-first drain).
int channel_push(void* h, const uint8_t* data, size_t n) {
  Channel* c = static_cast<Channel*>(h);
  std::vector<uint8_t> item(data, data + n);
  {
    std::lock_guard<std::mutex> lock(c->mu);
    if (c->closed) return -1;
    if (c->policy == CHANNEL_MAILBOX) {
      if (!c->items.empty()) {
        c->dropped += c->items.size();
        c->items.clear();
      }
    } else if (c->items.size() >= c->capacity) {
      c->items.pop_front();
      c->dropped++;
    }
    c->items.push_back(std::move(item));
    c->pushed++;
  }
  c->cv.notify_all();
  return 0;
}

// Pop the newest item (LIFO back()/pop_back, ThreadMapping.cpp:51-52),
// blocking up to timeout_ms. Returns payload size, 0 on timeout, -1 when
// closed and empty, -2 when the buffer is too small (item left queued).
int64_t channel_pop_wait(void* h, uint8_t* buf, size_t buf_size,
                         int64_t timeout_ms) {
  Channel* c = static_cast<Channel*>(h);
  std::unique_lock<std::mutex> lock(c->mu);
  if (c->items.empty()) {
    if (c->closed) return -1;
    if (timeout_ms > 0) {
      c->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                     [c] { return !c->items.empty() || c->closed; });
    }
    if (c->items.empty()) return c->closed ? -1 : 0;
  }
  std::vector<uint8_t>& item = c->items.back();
  if (item.size() > buf_size) return -2;
  int64_t n = static_cast<int64_t>(item.size());
  std::memcpy(buf, item.data(), item.size());
  c->items.pop_back();
  return n;
}

int64_t channel_pending(void* h) {
  Channel* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return static_cast<int64_t>(c->items.size());
}

uint64_t channel_dropped(void* h) {
  Channel* c = static_cast<Channel*>(h);
  std::lock_guard<std::mutex> lock(c->mu);
  return c->dropped;
}

void channel_close(void* h) {
  Channel* c = static_cast<Channel*>(h);
  {
    std::lock_guard<std::mutex> lock(c->mu);
    c->closed = true;
  }
  c->cv.notify_all();
}

// ---------------------------------------------------------------------------
// Timer (obcore/base/Timer: reset + elapsed seconds)
// ---------------------------------------------------------------------------

struct NativeTimer {
  std::chrono::steady_clock::time_point start;
};

void* timer_new() {
  NativeTimer* t = new NativeTimer();
  t->start = std::chrono::steady_clock::now();
  return t;
}

void timer_free(void* h) { delete static_cast<NativeTimer*>(h); }

void timer_reset(void* h) {
  static_cast<NativeTimer*>(h)->start = std::chrono::steady_clock::now();
}

double timer_elapsed(void* h) {
  auto now = std::chrono::steady_clock::now();
  return std::chrono::duration<double>(
             now - static_cast<NativeTimer*>(h)->start)
      .count();
}

// ---------------------------------------------------------------------------
// Logger (obcore/base/Logger: leveled, screen + file sinks)
// ---------------------------------------------------------------------------

enum LogLevel { LOG_ERROR = 0, LOG_WARN = 1, LOG_DEBUG = 2 };

struct NativeLogger {
  std::mutex mu;
  int screen_level = LOG_WARN;  // log up to this level to stderr
  int file_level = -1;          // -1 = file sink off
  FILE* file = nullptr;
};

static NativeLogger g_logger;

int logger_configure(int screen_level, int file_level, const char* path) {
  std::lock_guard<std::mutex> lock(g_logger.mu);
  g_logger.screen_level = screen_level;
  if (g_logger.file) {
    fclose(g_logger.file);
    g_logger.file = nullptr;
  }
  g_logger.file_level = file_level;
  if (file_level >= 0 && path && path[0]) {
    g_logger.file = fopen(path, "a");
    if (!g_logger.file) {
      g_logger.file_level = -1;
      return -1;
    }
  }
  return 0;
}

void logger_log(int level, const char* tag, const char* msg) {
  static const char* names[] = {"ERROR", "WARN", "DEBUG"};
  const char* name = (level >= 0 && level <= 2) ? names[level] : "?";
  std::lock_guard<std::mutex> lock(g_logger.mu);
  if (level <= g_logger.screen_level) {
    fprintf(stderr, "[%s] %s: %s\n", name, tag ? tag : "", msg ? msg : "");
  }
  if (g_logger.file && level <= g_logger.file_level) {
    fprintf(g_logger.file, "[%s] %s: %s\n", name, tag ? tag : "",
            msg ? msg : "");
    fflush(g_logger.file);
  }
}

// ---------------------------------------------------------------------------
// Image serializers (obcore/base/tools: PPM / PGM)
// ---------------------------------------------------------------------------

int serialize_ppm(const char* path, const uint8_t* rgb, int width,
                  int height) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P6\n%d %d\n255\n", width, height);
  size_t n = static_cast<size_t>(width) * height * 3;
  size_t written = fwrite(rgb, 1, n, f);
  fclose(f);
  return written == n ? 0 : -1;
}

int serialize_pgm(const char* path, const uint8_t* gray, int width,
                  int height) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P5\n%d %d\n255\n", width, height);
  size_t n = static_cast<size_t>(width) * height;
  size_t written = fwrite(gray, 1, n, f);
  fclose(f);
  return written == n ? 0 : -1;
}

}  // extern "C"
