// dcgan_tpu_torch native data loader: a copy of
// dcgan_tpu/data/native/loader.cc (the JAX package's C++ TFRecord loader),
// host code only, built with g++ and bound through ctypes (data/native.py).
//
// Pipeline: reader threads stream TFRecord shards in an endless loop,
// CRC32C-verify frames, parse the tf.train.Example wire format to extract one
// bytes feature (default "image_raw"), decode float64/float32/uint8 pixels to
// float32 (optionally normalizing to [-1,1]), push into a uniform-shuffle
// reservoir (capacity = min_after_dequeue + 3*batch), and assemble contiguous
// [B,H,W,C] float batches into a bounded prefetch queue consumed via the C
// API below.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC -pthread (see native.py); zero
// dependencies.

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <set>
#include <stdio.h>
#include <string>
#include <utility>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli). Hardware SSE4.2 crc32 instruction when the CPU has it
// (runtime-dispatched; the instruction computes exactly this polynomial),
// byte-table software fallback otherwise. The hardware path is 3-way
// interleaved: crc32q has ~3-cycle latency at 1/cycle throughput, so a single
// dependency chain runs the unit at 1/3 utilization; three independent chains
// over three 4 KB sub-chunks recover it, and a GF(2) zero-shift operator (the
// CRC-register evolution for 4096 zero bytes, built once by matrix squaring)
// stitches the three partial CRCs back into one stream.
// ---------------------------------------------------------------------------

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
      t[i] = crc;
    }
  }
};

const Crc32cTable& crc_table() {
  static const Crc32cTable table;
  return table;
}

uint32_t crc32c_sw(const uint8_t* data, size_t n) {
  const Crc32cTable& table = crc_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = table.t[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// GF(2) linear-operator machinery for the 3-way combine. The raw CRC
// register after k zero input bytes is a linear function of the register
// before them; ZERO_CHUNK's operator is built from the one-zero-byte matrix
// by log2(ZERO_CHUNK) squarings.
constexpr size_t ZERO_CHUNK = 4096;  // power of two; 3*4KB blocks

uint32_t gf2_times(const uint32_t mat[32], uint32_t vec) {
  uint32_t sum = 0;
  for (int i = 0; vec; vec >>= 1, ++i)
    if (vec & 1) sum ^= mat[i];
  return sum;
}

struct ZeroShift {
  uint32_t mat[32];  // register-evolution operator for ZERO_CHUNK zero bytes
  ZeroShift() {
    const Crc32cTable& table = crc_table();
    uint32_t m[32], sq[32];
    for (int i = 0; i < 32; ++i) {   // one zero byte: reg' = (reg>>8) ^ T[reg&FF]
      uint32_t reg = 1u << i;
      m[i] = (reg >> 8) ^ table.t[reg & 0xFF];
    }
    int shifts = 0;
    for (size_t c = ZERO_CHUNK; c > 1; c >>= 1) ++shifts;
    for (int s = 0; s < shifts; ++s) {
      for (int i = 0; i < 32; ++i) sq[i] = gf2_times(m, m[i]);
      memcpy(m, sq, sizeof m);
    }
    memcpy(mat, m, sizeof mat);
  }
};

const uint32_t* zero_shift() {
  static const ZeroShift z;
  return z.mat;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* data, size_t n) {
  const uint32_t* shift = zero_shift();
  uint32_t reg = 0xFFFFFFFFu;  // raw register; inverted once at the end
  while (n >= 3 * ZERO_CHUNK) {
    // three independent dependency chains over contiguous 4 KB sub-chunks
    uint64_t a = reg, b = 0, c = 0;
    const uint8_t* p0 = data;
    const uint8_t* p1 = data + ZERO_CHUNK;
    const uint8_t* p2 = data + 2 * ZERO_CHUNK;
    for (size_t i = 0; i < ZERO_CHUNK; i += 8) {
      uint64_t x, y, z;
      memcpy(&x, p0 + i, 8);  // unaligned-safe
      memcpy(&y, p1 + i, 8);
      memcpy(&z, p2 + i, 8);
      a = __builtin_ia32_crc32di(a, x);
      b = __builtin_ia32_crc32di(b, y);
      c = __builtin_ia32_crc32di(c, z);
    }
    // crc_raw(reg, c0||c1||c2) = M(M(a) ^ b) ^ c  with M = 4KB zero-shift
    reg = gf2_times(shift, gf2_times(shift, uint32_t(a)) ^ uint32_t(b)) ^
          uint32_t(c);
    data += 3 * ZERO_CHUNK;
    n -= 3 * ZERO_CHUNK;
  }
  uint64_t crc = reg;
  while (n >= 8) {
    uint64_t chunk;
    memcpy(&chunk, data, 8);
    crc = __builtin_ia32_crc32di(crc, chunk);
    data += 8;
    n -= 8;
  }
  uint32_t crc32 = uint32_t(crc);
  while (n--) crc32 = __builtin_ia32_crc32qi(crc32, *data++);
  return ~crc32;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  static const bool hw = __builtin_cpu_supports("sse4.2");
  return hw ? crc32c_hw(data, n) : crc32c_sw(data, n);
}
#else
uint32_t crc32c(const uint8_t* data, size_t n) { return crc32c_sw(data, n); }
#endif

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// Minimal protobuf wire parsing for tf.train.Example
// ---------------------------------------------------------------------------

bool read_varint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = buf[(*pos)++];
    result |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = result; return true; }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

struct Slice { const uint8_t* p = nullptr; size_t n = 0; };

// Scan a length-delimited submessage for the first field `field_num` with
// wire type 2, returning its payload. Returns false if absent/malformed.
bool find_len_field(Slice msg, uint32_t field_num, Slice* out, size_t* resume) {
  size_t pos = resume ? *resume : 0;
  while (pos < msg.n) {
    uint64_t tag;
    if (!read_varint(msg.p, msg.n, &pos, &tag)) return false;
    uint32_t field = uint32_t(tag >> 3), wt = uint32_t(tag & 7);
    if (wt == 2) {
      uint64_t len;
      if (!read_varint(msg.p, msg.n, &pos, &len) || pos + len > msg.n)
        return false;
      if (field == field_num) {
        *out = {msg.p + pos, size_t(len)};
        if (resume) *resume = pos + len;
        return true;
      }
      pos += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!read_varint(msg.p, msg.n, &pos, &v)) return false;
    } else if (wt == 1) {
      pos += 8;
    } else if (wt == 5) {
      pos += 4;
    } else {
      return false;
    }
  }
  return false;
}

// Example(1) -> the Features submessage holding the feature map. Parsed once
// per record; both feature extractors below then scan this slice.
bool get_features(Slice example, Slice* features) {
  return find_len_field(example, 1, features, nullptr);
}

// Iterate Features' map entries feature(1) {key(1), value(2)}: each call
// yields the next Feature value whose key equals `feature_name` (empty name
// matches every entry). `resume` carries the scan position across calls.
bool next_feature(Slice features, const std::string& feature_name, Slice* out,
                  size_t* resume) {
  Slice entry;
  while (find_len_field(features, 1, &entry, resume)) {
    Slice key{nullptr, 0}, value{nullptr, 0};
    find_len_field(entry, 1, &key, nullptr);
    if (!find_len_field(entry, 2, &value, nullptr)) continue;
    if (!feature_name.empty() &&
        (key.n != feature_name.size() ||
         memcmp(key.p, feature_name.data(), key.n) != 0))
      continue;
    *out = value;
    return true;
  }
  return false;
}

// Feature.bytes_list(1).value(1): first bytes payload of the named feature.
// An empty name matches the first entry that *has* a bytes_list (entries of
// other types — e.g. an int64 label preceding the image in map order — are
// skipped, not errors).
bool extract_bytes_feature(Slice features, const std::string& feature_name,
                           Slice* out) {
  size_t resume = 0;
  Slice value;
  while (next_feature(features, feature_name, &value, &resume)) {
    Slice bytes_list;
    if (!find_len_field(value, 1, &bytes_list, nullptr)) {  // oneof=1
      if (feature_name.empty()) continue;  // wrong-typed entry; keep looking
      return false;
    }
    if (find_len_field(bytes_list, 1, out, nullptr)) return true;
    if (!feature_name.empty()) return false;
  }
  return false;
}

// Feature.int64_list(3).value(1): first int64 of the named feature. The
// value field may be packed (wire type 2, TF's writer) or plain varints.
bool extract_int64_feature(Slice features, const std::string& feature_name,
                           int64_t* out) {
  size_t fresume = 0;
  Slice value;
  if (!next_feature(features, feature_name, &value, &fresume)) return false;
  Slice int64_list;
  if (!find_len_field(value, 3, &int64_list, nullptr)) return false;  // oneof=3
  size_t pos = 0;
  while (pos < int64_list.n) {
    uint64_t tag;
    if (!read_varint(int64_list.p, int64_list.n, &pos, &tag)) return false;
    uint32_t field = uint32_t(tag >> 3), wt = uint32_t(tag & 7);
    if (field == 1 && wt == 0) {
      uint64_t v;
      if (!read_varint(int64_list.p, int64_list.n, &pos, &v)) return false;
      *out = int64_t(v);
      return true;
    }
    if (field == 1 && wt == 2) {
      uint64_t len;
      if (!read_varint(int64_list.p, int64_list.n, &pos, &len) ||
          pos + len > int64_list.n)
        return false;
      if (len == 0) { continue; }
      size_t p2 = pos;
      uint64_t v;
      if (!read_varint(int64_list.p, pos + size_t(len), &p2, &v)) return false;
      *out = int64_t(v);
      return true;
    }
    if (wt == 0) {
      uint64_t v;
      if (!read_varint(int64_list.p, int64_list.n, &pos, &v)) return false;
    } else if (wt == 2) {
      uint64_t len;
      if (!read_varint(int64_list.p, int64_list.n, &pos, &len)) return false;
      pos += len;
    } else if (wt == 1) {
      pos += 8;
    } else if (wt == 5) {
      pos += 4;
    } else {
      return false;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// Loader
// ---------------------------------------------------------------------------

enum RecordDtype { DT_F64 = 0, DT_F32 = 1, DT_U8 = 2 };

struct LoaderConfig {
  std::vector<std::string> paths;
  int batch = 64;
  size_t example_floats = 0;   // h*w*c
  RecordDtype dtype = DT_F64;
  int min_after_dequeue = 10776;  // 10% of a CelebA epoch
  int n_threads = 16;
  int prefetch_batches = 4;
  uint64_t seed = 0;
  bool normalize = true;          // x/127.5 - 1
  bool verify_crc = true;
  int64_t max_corrupt = 0;        // >0: quarantine (skip + count) up to this
                                  // many corrupt records before failing the
                                  // stream; 0 = fail-fast
  std::string feature_name = "image_raw";
  std::string label_feature;      // non-empty: also read an int64 label per
                                  // example
  bool loop = true;               // endless epochs (queue-runner semantics)

  bool labeled() const { return !label_feature.empty(); }
  // pooled examples carry the label as one trailing float so the shuffle
  // pool / batcher stay image-vs-labeled agnostic
  size_t stride() const { return example_floats + (labeled() ? 1 : 0); }
};

class Loader {
 public:
  explicit Loader(LoaderConfig cfg) : cfg_(std::move(cfg)), rng_(cfg_.seed) {
    capacity_ = size_t(cfg_.min_after_dequeue) + 3 * size_t(cfg_.batch);
    int n = std::max(1, std::min<int>(cfg_.n_threads, int(cfg_.paths.size())));
    // n_readers_ must be written BEFORE any reader starts: the completion
    // check below compares readers_done_ against it, and readers_.size()
    // is NOT safe to read from the reader threads (emplace_back's size
    // update is unsynchronized with the thread it spawns — a reader that
    // finished a tiny shard quickly could read a stale size, never set
    // done_, and deadlock Next() forever).
    n_readers_ = n;
    readers_.reserve(n);
    for (int t = 0; t < n; ++t)
      readers_.emplace_back(&Loader::ReaderLoop, this, t, n);
    batcher_ = std::thread(&Loader::BatcherLoop, this);
  }

  ~Loader() {
    Stop();
    for (auto& t : readers_) t.join();
    batcher_.join();
  }

  // Halt the worker threads and unblock any Next() caller WITHOUT
  // releasing the handle. Consumers that drive Next() from their own
  // thread (data/pipeline.py's DevicePrefetcher) must call this, join
  // their thread, and only then destroy: deleting the Loader while a
  // thread is parked in Next()'s condvar wait tears the mutex/cv down
  // under it (a use-after-free).
  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    pool_cv_.notify_all();
    space_cv_.notify_all();
    batch_cv_.notify_all();
  }

  // 0 = ok; 1 = end of data (non-loop mode); -1 = error (see error()).
  // out_labels may be null for unlabeled configs.
  int Next(float* out, int32_t* out_labels) {
    std::unique_lock<std::mutex> lk(mu_);
    // End-of-data only when the pool can no longer fill a batch AND the
    // batcher is not mid-assembly (batching_): it drains the pool under the
    // lock but publishes to batches_ later — without the flag a consumer
    // waking in that window would report EOF and drop the final batch.
    while (!batch_cv_.wait_for(lk, std::chrono::seconds(5), [&] {
      return !batches_.empty() ||
             (done_ && !batching_ && pool_.size() < size_t(cfg_.batch))
             || !error_.empty() || stop_;
    })) {
      if (getenv("DCGAN_LOADER_DEBUG")) {
        fprintf(stderr,
                "[loader] Next waiting: batches=%zu pool=%zu done=%d "
                "readers_done=%d/%d batching=%d stop=%d err='%s'\n",
                batches_.size(), pool_.size(), int(done_),
                readers_done_, n_readers_, int(batching_), int(stop_),
                error_.c_str());
      }
    }
    if (!error_.empty()) return -1;
    if (batches_.empty()) return 1;
    std::vector<float> b = std::move(batches_.front());
    batches_.pop_front();
    lk.unlock();
    space_cv_.notify_one();
    batch_cv_.notify_all();  // the batcher waits for prefetch space on this cv
    if (!cfg_.labeled()) {
      memcpy(out, b.data(), b.size() * sizeof(float));
      return 0;
    }
    const size_t ex_n = cfg_.example_floats, stride = cfg_.stride();
    for (int i = 0; i < cfg_.batch; ++i) {
      const float* src = b.data() + size_t(i) * stride;
      memcpy(out + size_t(i) * ex_n, src, ex_n * sizeof(float));
      if (out_labels) out_labels[i] = int32_t(src[ex_n]);
    }
    return 0;
  }

  const char* error() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_.c_str();
  }

  int64_t corrupt_count() const { return corrupt_count_.load(); }

 private:
  void Fail(const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu_);
    if (error_.empty()) error_ = msg;
    batch_cv_.notify_all();
  }

  // Corrupt-record quarantine (--max_corrupt_records): true = the record is
  // counted and the caller skips what it safely can; false = quarantine is
  // off (fail-fast) or the budget is exhausted — the stream is failed
  // and the caller must stop. The file+offset log line is what the operator
  // repairs from. Looping datasets re-encounter the same bad record every
  // epoch: repeats are skipped silently (counted and logged once), so the
  // budget bounds DISTINCT corrupt records, not epochs survived.
  bool Quarantine(const std::string& what, const std::string& path,
                  long offset) {
    if (cfg_.max_corrupt <= 0) {
      // fail-fast: the record is not quarantined, so it does not count as
      // one
      Fail(what + " in " + path);
      return false;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (!quarantined_.insert({path, offset}).second) return true;
    }
    int64_t seen = ++corrupt_count_;
    if (seen > cfg_.max_corrupt) {
      Fail(what + " in " + path + " (corrupt-record budget " +
           std::to_string(cfg_.max_corrupt) + " exhausted)");
      return false;
    }
    fprintf(stderr,
            "[dcgan_loader] quarantined corrupt record: %s (%s @ byte %ld; "
            "%lld/%lld of budget)\n",
            what.c_str(), path.c_str(), offset, (long long)seen,
            (long long)cfg_.max_corrupt);
    return true;
  }

  bool DecodeExample(Slice payload, std::vector<float>* out) {
    // Normalization (raw pixel scale [0,255] -> tanh range [-1,1]) is fused
    // into the dtype-conversion loop — one pass over the example, not two.
    const size_t n = cfg_.example_floats;
    const bool norm = cfg_.normalize;
    const float s = 1.0f / 127.5f;
    out->resize(cfg_.stride());
    float* dst = out->data();
    // Every normalize=false branch is a plain cast/copy (no *1+0, which is
    // not foldable — it would flip -0.0 to +0.0 and cost a FMA per element
    // on the strict-parity path).
    if (cfg_.dtype == DT_F64) {
      if (payload.n != n * 8) return false;
      const double* src = reinterpret_cast<const double*>(payload.p);
      if (norm) {
        for (size_t i = 0; i < n; ++i) dst[i] = float(src[i]) * s - 1.0f;
      } else {
        for (size_t i = 0; i < n; ++i) dst[i] = float(src[i]);
      }
    } else if (cfg_.dtype == DT_F32) {
      if (payload.n != n * 4) return false;
      if (norm) {
        const float* src = reinterpret_cast<const float*>(payload.p);
        for (size_t i = 0; i < n; ++i) dst[i] = src[i] * s - 1.0f;
      } else {
        memcpy(dst, payload.p, n * 4);
      }
    } else {
      if (payload.n != n) return false;
      if (norm) {
        for (size_t i = 0; i < n; ++i) dst[i] = float(payload.p[i]) * s - 1.0f;
      } else {
        for (size_t i = 0; i < n; ++i) dst[i] = float(payload.p[i]);
      }
    }
    return true;
  }

  void PushExample(std::vector<float> ex) {
    std::unique_lock<std::mutex> lk(mu_);
    space_cv_.wait(lk, [&] { return pool_.size() < capacity_ || stop_; });
    if (stop_) return;
    pool_.push_back(std::move(ex));
    if (pool_.size() >= size_t(cfg_.min_after_dequeue) ||
        (done_ && pool_.size() >= size_t(cfg_.batch)))
      pool_cv_.notify_one();
  }

  void ReaderLoop(int tid, int n_threads) {
    std::vector<uint8_t> buf;
    bool first_pass = true;
    while (true) {
      bool read_any = false;
      for (size_t fi = tid; fi < cfg_.paths.size(); fi += n_threads) {
        {
          std::lock_guard<std::mutex> lk(mu_);
          if (stop_) return;
        }
        FILE* f = fopen(cfg_.paths[fi].c_str(), "rb");
        if (!f) {
          Fail("cannot open shard: " + cfg_.paths[fi]);
          return;
        }
        // Per-record failure routing: a data-CRC/parse failure quarantines
        // just that record (framing intact — skip and continue); a length-
        // CRC mismatch or short read leaves no trusted resync point, so the
        // rest of the file is abandoned. Quarantine() returning false means
        // the stream has been failed (budget off or exhausted): stop.
        bool give_up = false;       // stream failed — thread exits
        uint8_t header[12];
        long rec_off;
        while (rec_off = ftell(f), fread(header, 1, 12, f) == 12) {
          uint64_t len;
          memcpy(&len, header, 8);
          if (cfg_.verify_crc) {
            uint32_t lcrc;
            memcpy(&lcrc, header + 8, 4);
            if (masked_crc32c(header, 8) != lcrc) {
              give_up = !Quarantine("length CRC mismatch", cfg_.paths[fi],
                                    rec_off);
              break;  // length untrusted: abandon the rest of this file
            }
          }
          buf.resize(len + 4);
          if (fread(buf.data(), 1, len + 4, f) != len + 4) {
            give_up = !Quarantine("truncated record", cfg_.paths[fi],
                                  rec_off);
            break;
          }
          if (cfg_.verify_crc) {
            uint32_t dcrc;
            memcpy(&dcrc, buf.data() + len, 4);
            if (masked_crc32c(buf.data(), len) != dcrc) {
              if (Quarantine("data CRC mismatch", cfg_.paths[fi], rec_off))
                continue;  // framing intact: skip just this record
              give_up = true;
              break;
            }
          }
          Slice features;
          Slice payload;
          std::vector<float> ex;
          std::string why;
          if (!get_features({buf.data(), size_t(len)}, &features)) {
            why = "malformed Example";
          } else if (!extract_bytes_feature(features, cfg_.feature_name,
                                            &payload)) {
            why = "record missing feature '" + cfg_.feature_name + "'";
          } else if (!DecodeExample(payload, &ex)) {
            why = "bad example payload size";
          } else if (cfg_.labeled()) {
            int64_t label = 0;
            if (!extract_int64_feature(features, cfg_.label_feature,
                                       &label)) {
              why = "record missing int64 feature '" + cfg_.label_feature +
                    "'";
            } else if (label < 0 || label > (int64_t(1) << 24)) {
              // labels ride a float32 pool slot; beyond 2^24 that
              // representation is lossy, so reject rather than silently
              // corrupt class ids
              why = "label " + std::to_string(label) +
                    " out of range [0, 2^24]";
            } else {
              ex[cfg_.example_floats] = float(label);
            }
          }
          if (!why.empty()) {
            if (Quarantine(why, cfg_.paths[fi], rec_off))
              continue;  // skip just this record
            give_up = true;
            break;
          }
          read_any = true;
          PushExample(std::move(ex));
          {
            std::lock_guard<std::mutex> lk(mu_);
            if (stop_) { fclose(f); return; }
          }
        }
        fclose(f);
        if (give_up) return;
      }
      if (first_pass && !read_any && tid == 0 && cfg_.paths.empty()) {
        Fail("no shards given");
        return;
      }
      first_pass = false;
      if (!cfg_.loop) break;
      if (!read_any) break;  // all assigned shards empty: avoid a spin loop
    }
    // non-loop mode: signal completion when the last reader exits
    std::lock_guard<std::mutex> lk(mu_);
    if (++readers_done_ == n_readers_) {
      done_ = true;
      pool_cv_.notify_all();
      batch_cv_.notify_all();
    }
  }

  void BatcherLoop() {
    const size_t ex_n = cfg_.stride();
    while (true) {
      std::vector<std::vector<float>> picked;
      {
        std::unique_lock<std::mutex> lk(mu_);
        pool_cv_.wait(lk, [&] {
          return stop_ || !error_.empty() ||
                 pool_.size() >= size_t(cfg_.min_after_dequeue) + size_t(cfg_.batch) ||
                 (done_ && pool_.size() >= size_t(cfg_.batch));
        });
        if (stop_ || !error_.empty()) return;
        // uniform shuffle: swap a random element to the back, pop it —
        // the dequeue-many semantics of tf.train.shuffle_batch
        for (int i = 0; i < cfg_.batch; ++i) {
          size_t j = std::uniform_int_distribution<size_t>(
              0, pool_.size() - 1)(rng_);
          std::swap(pool_[j], pool_.back());
          picked.push_back(std::move(pool_.back()));
          pool_.pop_back();
        }
        batching_ = true;  // a batch is in flight until published below
      }
      space_cv_.notify_all();
      std::vector<float> batch(size_t(cfg_.batch) * ex_n);
      for (int i = 0; i < cfg_.batch; ++i)
        memcpy(batch.data() + size_t(i) * ex_n, picked[i].data(),
               ex_n * sizeof(float));
      {
        std::unique_lock<std::mutex> lk(mu_);
        batch_cv_.wait(lk, [&] {
          return batches_.size() < size_t(cfg_.prefetch_batches) || stop_;
        });
        if (stop_) return;
        batches_.push_back(std::move(batch));
        batching_ = false;
      }
      batch_cv_.notify_all();
    }
  }

  LoaderConfig cfg_;
  size_t capacity_;
  std::mt19937_64 rng_;

  std::mutex mu_;
  std::condition_variable pool_cv_, space_cv_, batch_cv_;
  std::vector<std::vector<float>> pool_;
  std::deque<std::vector<float>> batches_;
  std::string error_;
  std::atomic<int64_t> corrupt_count_{0};
  std::set<std::pair<std::string, long>> quarantined_;  // (shard, offset)
  bool stop_ = false;
  bool done_ = false;
  bool batching_ = false;   // batcher holds picked examples not yet published
  int readers_done_ = 0;
  int n_readers_ = 0;       // written before threads start; readers_.size()
                            // is not safely readable from reader threads

  std::vector<std::thread> readers_;
  std::thread batcher_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* dcgan_loader_create(const char** paths, int n_paths, int batch,
                          int example_floats, int record_dtype,
                          int min_after_dequeue, int n_threads,
                          int prefetch_batches, uint64_t seed, int normalize,
                          int verify_crc, int loop, const char* feature_name,
                          const char* label_feature, long long max_corrupt) {
  LoaderConfig cfg;
  for (int i = 0; i < n_paths; ++i) cfg.paths.emplace_back(paths[i]);
  cfg.batch = batch;
  cfg.example_floats = size_t(example_floats);
  cfg.dtype = RecordDtype(record_dtype);
  cfg.min_after_dequeue = min_after_dequeue;
  cfg.n_threads = n_threads;
  cfg.prefetch_batches = prefetch_batches;
  cfg.seed = seed;
  cfg.normalize = normalize != 0;
  cfg.verify_crc = verify_crc != 0;
  cfg.loop = loop != 0;
  if (feature_name) cfg.feature_name = feature_name;
  if (label_feature) cfg.label_feature = label_feature;
  cfg.max_corrupt = int64_t(max_corrupt);
  return new Loader(std::move(cfg));
}

// out_labels: int32[batch] when the loader was created with a label_feature;
// pass null for unlabeled configs.
int dcgan_loader_next(void* handle, float* out, int32_t* out_labels) {
  return static_cast<Loader*>(handle)->Next(out, out_labels);
}

const char* dcgan_loader_error(void* handle) {
  return static_cast<Loader*>(handle)->error();
}

// Records quarantined (skipped) so far under max_corrupt > 0; also counts
// the final budget-exhausting record once the stream has failed.
long long dcgan_loader_corrupt_count(void* handle) {
  return static_cast<Loader*>(handle)->corrupt_count();
}

// Non-destructive stop: unblocks a Next() parked on another thread so the
// caller can join it before dcgan_loader_destroy (see Loader::Stop).
void dcgan_loader_stop(void* handle) {
  static_cast<Loader*>(handle)->Stop();
}

void dcgan_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
