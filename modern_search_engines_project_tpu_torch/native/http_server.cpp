// Fast-path HTTP serving core (first-party C++; no third-party deps).
//
// Started as a copy of the reference package's native/http_server.cpp;
// the port adds the request timing of stats_json (queue wait, host time
// and a log-scale histogram of host latency, all on steady_clock, the
// clock of Python's time.monotonic()).  The full-featured control plane is
// the asyncio app (serving/api.py, 16 routes); THIS file is the hot-path
// data plane: an epoll HTTP/1.1 server that handles POST /api/search with
// ~50 us of host work per request, so one host core can feed the card
// with coalesced batches.
//
// Design:
//   * N event-loop threads (epoll, EPOLLEXCLUSIVE accept on a shared
//     SO_REUSEPORT listening socket; multiple PROCESSES can also share the
//     port for per-replica deployments).
//   * Requests parse to (query, top_k, query_id) and enter a C++ online
//     batcher (mutex+condvar MPMC queue); a dispatcher thread drains up to
//     max_batch items (waiting batch_window_us after the first) and ranks
//     the whole batch in ONE call — exactly the QueryBatcher->device-batch
//     pattern of serving/batcher.py, but with no interpreter on the path.
//   * Ranking is either (a) a canned stub (host-ceiling load tests), or
//     (b) a registered callback — Python ctypes trampolines into
//     engine.search_batch_indices, which launches the CUDA kernels.
//   * Responses splice pre-escaped per-chunk JSON fragments (url/title/
//     snippet/domain/doc_id) loaded once at startup — the same
//     pre-escaping trick serving/api.py uses, hoisted to C++.
//
// Exposed C ABI (ctypes bridge: native/native_http.py):
//   msetpu_http_create / set_stub / set_rank_callback / load_fragments /
//   msetpu_http_start / stop / destroy / stats_json / msetpu_http_free
//   msetpu_http_client_bench  (epoll load generator, for load tests)

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double now_ms() {
  return std::chrono::duration<double, std::milli>(
             Clock::now().time_since_epoch())
      .count();
}

uint64_t us_between(Clock::time_point a, Clock::time_point b) {
  auto d = std::chrono::duration_cast<std::chrono::microseconds>(b - a);
  return d.count() > 0 ? (uint64_t)d.count() : 0;
}

// host-latency histogram: bucket i holds [2^(i/8), 2^((i+1)/8)) us, so a
// percentile read from it is within ~4.4% of the latency it stands for
constexpr int kLatPerOctave = 8;
constexpr int kLatBuckets = 40 * kLatPerOctave;  // up to 2^40 us

int lat_bucket(uint64_t us) {
  if (us <= 1) return 0;
  int b = (int)(std::log2((double)us) * kLatPerOctave);
  return std::min(b, kLatBuckets - 1);
}

// ---------------------------------------------------------------------------
// minimal JSON helpers (request bodies are tiny, flat objects)
// ---------------------------------------------------------------------------

// Finds "key" : <string> and returns the unescaped value.  Returns false if
// absent or not a string.
bool json_get_string(const std::string& body, const char* key,
                     std::string* out) {
  std::string pat = std::string("\"") + key + "\"";
  size_t p = body.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < body.size() && (body[p] == ' ' || body[p] == '\t' ||
                             body[p] == '\n' || body[p] == '\r'))
    p++;
  if (p >= body.size() || body[p] != ':') return false;
  p++;
  while (p < body.size() && (body[p] == ' ' || body[p] == '\t' ||
                             body[p] == '\n' || body[p] == '\r'))
    p++;
  if (p >= body.size() || body[p] != '"') return false;
  p++;
  out->clear();
  while (p < body.size()) {
    char c = body[p];
    if (c == '"') return true;
    if (c == '\\' && p + 1 < body.size()) {
      char e = body[p + 1];
      p += 2;
      switch (e) {
        case 'n': out->push_back('\n'); break;
        case 't': out->push_back('\t'); break;
        case 'r': out->push_back('\r'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case '/': out->push_back('/'); break;
        case '\\': out->push_back('\\'); break;
        case '"': out->push_back('"'); break;
        case 'u': {
          if (p + 4 <= body.size()) {
            unsigned cp = 0;
            bool ok = true;
            for (int i = 0; i < 4; i++) {
              char h = body[p + i];
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else { ok = false; break; }
            }
            if (ok) {
              p += 4;
              // encode UTF-8 (surrogate pairs: keep the BMP half only —
              // queries with astral chars still parse, slightly lossy)
              if (cp < 0x80) out->push_back((char)cp);
              else if (cp < 0x800) {
                out->push_back((char)(0xC0 | (cp >> 6)));
                out->push_back((char)(0x80 | (cp & 0x3F)));
              } else {
                out->push_back((char)(0xE0 | (cp >> 12)));
                out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                out->push_back((char)(0x80 | (cp & 0x3F)));
              }
            }
          }
          break;
        }
        default: out->push_back(e);
      }
      continue;
    }
    out->push_back(c);
    p++;
  }
  return false;  // unterminated
}

bool json_get_int(const std::string& body, const char* key, long* out) {
  std::string pat = std::string("\"") + key + "\"";
  size_t p = body.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < body.size() && body[p] != ':') p++;
  if (p >= body.size()) return false;
  p++;
  while (p < body.size() && (body[p] == ' ')) p++;
  char* end = nullptr;
  long v = strtol(body.c_str() + p, &end, 10);
  if (end == body.c_str() + p) return false;
  *out = v;
  return true;
}

void json_escape_into(const std::string& s, std::string* out) {
  for (unsigned char c : s) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\r': *out += "\\r"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          *out += buf;
        } else {
          out->push_back((char)c);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// server
// ---------------------------------------------------------------------------

struct Conn {
  int fd = -1;
  uint64_t id = 0;
  std::string rbuf;   // unparsed input
  std::string wbuf;   // unsent output
  bool want_write = false;
  bool awaiting_rank = false;  // one in-flight /api/search per conn
  bool closing = false;    // EOF seen: finish buffered work, then close
  bool peer_gone = false;  // hard send error: nothing can reach the peer
};

struct Pending {
  uint64_t conn_id;
  int thread_idx;
  std::string query;
  std::string query_id;  // raw (unescaped)
  int top_k;
  Clock::time_point t_enq;  // parsed
};

struct Response {
  uint64_t conn_id;
  std::string body;  // full HTTP bytes
};

// rank callback ABI: fill out_idx/out_scores with up to top_k entries per
// query (row-major [n, top_k]); out_counts[i] = real count for query i.
// Returns 0 on success.
typedef int (*rank_cb_t)(const char** queries, int n, int top_k,
                         int32_t* out_idx, float* out_scores,
                         int32_t* out_counts, void* user);

struct Server;

struct EventThread {
  Server* srv = nullptr;
  int idx = 0;
  int ep = -1;
  int wake_fd = -1;  // eventfd: dispatcher -> this thread
  std::thread th;
  std::unordered_map<uint64_t, Conn*> conns;
  std::mutex outbox_mu;
  std::vector<Response> outbox;
};

struct Server {
  int port = 0;
  int n_threads = 1;
  int max_batch = 64;
  int batch_window_us = 200;
  int listen_fd = -1;
  std::atomic<bool> running{false};
  // 0 and 1 are the listen / wake epoll markers — conn ids start above
  std::atomic<uint64_t> next_conn_id{2};
  std::vector<EventThread*> threads;

  // batcher.  n_dispatchers > 1 pipelines device dispatch: while one
  // dispatcher blocks inside the rank callback waiting on device results
  // (the Python half releases the GIL for the wait), another drains the
  // queue, preps and dispatches the NEXT batch — the device queue stays
  // fed instead of idling a full round trip between batches.  Per-conn
  // ordering is safe by construction (awaiting_rank allows one in-flight
  // rank per connection).
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<Pending> queue;
  int n_dispatchers = 1;
  std::vector<std::thread> dispatchers;

  // ranking + doc table — swappable at runtime (index reload): readers
  // snapshot under cfg_mu, writers replace under cfg_mu.  The fragment
  // table is a shared_ptr so an in-flight response keeps the generation
  // it started with while a reload installs the next one.
  std::mutex cfg_mu;
  rank_cb_t rank_cb = nullptr;
  void* rank_user = nullptr;
  std::vector<int32_t> stub_idx;     // canned top-k (stub mode)
  std::vector<float> stub_scores;
  int default_top_k = 100;
  std::shared_ptr<const std::vector<std::string>> fragments =
      std::make_shared<const std::vector<std::string>>();

  // stats
  std::atomic<uint64_t> served{0};
  std::atomic<uint64_t> batches{0};
  std::atomic<uint64_t> batched_queries{0};
  std::atomic<uint64_t> bad_requests{0};
  std::atomic<uint64_t> health_hits{0};
  // request timing, in us: parsed -> taken into a batch by a dispatcher
  // (the batch window included), and parsed -> reply handed to the event
  // thread; queued counts the requests taken
  std::atomic<uint64_t> queued{0};
  std::atomic<uint64_t> queue_wait_us{0};
  std::atomic<uint64_t> host_us{0};
  std::atomic<uint64_t> host_hist[kLatBuckets] = {};
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

std::string make_response(const std::string& body, int code = 200,
                          const char* status = "OK") {
  std::string out = "HTTP/1.1 " + std::to_string(code) + " " + status +
                    "\r\nContent-Type: application/json\r\nContent-Length: " +
                    std::to_string(body.size()) +
                    "\r\nConnection: keep-alive\r\n\r\n";
  out += body;
  return out;
}

void conn_close(EventThread* t, Conn* c) {
  epoll_ctl(t->ep, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  t->conns.erase(c->id);
  delete c;
}

void conn_flush(EventThread* t, Conn* c) {
  while (!c->wbuf.empty()) {
    ssize_t n = send(c->fd, c->wbuf.data(), c->wbuf.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->wbuf.erase(0, (size_t)n);
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      // hard send error: nothing more can reach this peer
      c->wbuf.clear();
      c->closing = true;
      c->peer_gone = true;
      return;
    }
  }
  bool need_write = !c->wbuf.empty();
  if (need_write != c->want_write) {
    c->want_write = need_write;
    // after EOF (closing) there is nothing left to read — keeping EPOLLIN
    // armed would busy-spin the level-triggered loop on the readable EOF
    epoll_event ev{};
    ev.events = (c->closing ? 0 : EPOLLIN) | (need_write ? EPOLLOUT : 0);
    ev.data.u64 = c->id;
    epoll_ctl(t->ep, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

// Parse as many complete HTTP requests as are buffered on c; returns false
// if the connection should close.
bool conn_process(EventThread* t, Conn* c);

void handle_request(EventThread* t, Conn* c, const std::string& method,
                    const std::string& path, const std::string& body) {
  Server* s = t->srv;
  if (method == "GET" &&
      (path == "/api/health" || path == "/health")) {
    s->health_hits++;
    c->wbuf += make_response(
        "{\"status\": \"healthy\", \"search_engine_ready\": true}");
    return;
  }
  if (method == "POST" && path == "/api/search") {
    std::string query;
    if (!json_get_string(body, "query", &query) || query.empty()) {
      s->bad_requests++;
      c->wbuf += make_response("{\"error\": \"Query is required\"}", 400,
                               "Bad Request");
      return;
    }
    long top_k = s->default_top_k;
    json_get_int(body, "top_k", &top_k);
    if (top_k < 1) top_k = 1;
    if (top_k > 1000) top_k = 1000;
    std::string qid;
    json_get_string(body, "query_id", &qid);
    Pending p;
    p.conn_id = c->id;
    p.thread_idx = t->idx;
    p.query = std::move(query);
    p.query_id = std::move(qid);
    p.top_k = (int)top_k;
    p.t_enq = Clock::now();
    c->awaiting_rank = true;
    {
      std::lock_guard<std::mutex> lk(s->q_mu);
      s->queue.push_back(std::move(p));
    }
    s->q_cv.notify_one();
    return;
  }
  c->wbuf += make_response("{\"error\": \"not found\"}", 404, "Not Found");
}

bool conn_process(EventThread* t, Conn* c) {
  for (;;) {
    if (c->awaiting_rank) return true;  // finish current request first
    size_t hdr_end = c->rbuf.find("\r\n\r\n");
    if (hdr_end == std::string::npos) {
      if (c->closing) {
        // EOF already seen: no more bytes will ever arrive.  Close once
        // the write buffer drains (EPOLLOUT path closes it otherwise).
        return !c->wbuf.empty();
      }
      return c->rbuf.size() < (1 << 20);  // header flood guard
    }
    // request line
    size_t line_end = c->rbuf.find("\r\n");
    std::string line = c->rbuf.substr(0, line_end);
    size_t sp1 = line.find(' ');
    size_t sp2 = line.find(' ', sp1 + 1);
    if (sp1 == std::string::npos || sp2 == std::string::npos) return false;
    std::string method = line.substr(0, sp1);
    std::string path = line.substr(sp1 + 1, sp2 - sp1 - 1);
    // content-length (case-insensitive scan within headers)
    size_t clen = 0;
    {
      std::string hdrs = c->rbuf.substr(0, hdr_end + 2);
      for (size_t i = 0; i + 15 < hdrs.size(); i++) {
        if (strncasecmp(hdrs.c_str() + i, "content-length:", 15) == 0) {
          clen = strtoul(hdrs.c_str() + i + 15, nullptr, 10);
          break;
        }
      }
    }
    // reject oversized/overflowing lengths up front: an attacker-supplied
    // value near SIZE_MAX (or "-1", which strtoul wraps) must not overflow
    // `total` below and desynchronize request framing
    if (clen > (15u << 20)) {
      c->wbuf += make_response("{\"error\": \"payload too large\"}", 413,
                               "Payload Too Large");
      conn_flush(t, c);
      return false;
    }
    size_t total = hdr_end + 4 + clen;
    if (c->rbuf.size() < total) {
      return total < (16u << 20);  // body size guard
    }
    std::string body = c->rbuf.substr(hdr_end + 4, clen);
    c->rbuf.erase(0, total);
    handle_request(t, c, method, path, body);
    conn_flush(t, c);
    // A half-closed peer (closing after EOF) may have pipelined further
    // requests — keep looping; the no-more-headers branch above (and the
    // EPOLLOUT drain) decide when to actually close.  A hard send error
    // is different: nothing can reach that peer, stop immediately.
    if (c->peer_gone) return false;
  }
}

void event_loop(EventThread* t) {
  Server* s = t->srv;
  epoll_event evs[256];
  while (s->running.load(std::memory_order_relaxed)) {
    int n = epoll_wait(t->ep, evs, 256, 100);
    for (int i = 0; i < n; i++) {
      uint64_t id = evs[i].data.u64;
      if (id == 0) {  // listen fd
        for (;;) {
          int fd = accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (fd < 0) break;
          int one = 1;
          setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Conn* c = new Conn();
          c->fd = fd;
          c->id = s->next_conn_id.fetch_add(1);
          t->conns[c->id] = c;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = c->id;
          epoll_ctl(t->ep, EPOLL_CTL_ADD, fd, &ev);
        }
        continue;
      }
      if (id == 1) {  // wake eventfd: drain outbox
        uint64_t junk;
        while (read(t->wake_fd, &junk, 8) > 0) {}
        std::vector<Response> out;
        {
          std::lock_guard<std::mutex> lk(t->outbox_mu);
          out.swap(t->outbox);
        }
        for (auto& r : out) {
          auto it = t->conns.find(r.conn_id);
          if (it == t->conns.end()) continue;  // conn died while ranking
          Conn* c = it->second;
          c->awaiting_rank = false;
          c->wbuf += r.body;
          conn_flush(t, c);
          // half-closed peers (closing set at EOF) still get their
          // response: process any pipelined requests first, then close
          // only once wbuf is drained (partial sends arm EPOLLOUT and
          // finish there)
          if (!conn_process(t, c) ||
              (c->closing && !c->awaiting_rank && c->wbuf.empty()))
            conn_close(t, c);
        }
        continue;
      }
      auto it = t->conns.find(id);
      if (it == t->conns.end()) continue;
      Conn* c = it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        conn_close(t, c);
        continue;
      }
      if (evs[i].events & EPOLLOUT) {
        conn_flush(t, c);
        // close once drained — unless a rank (for a pipelined request on
        // this half-closed conn) is still outstanding
        if (c->closing && c->wbuf.empty() && !c->awaiting_rank) {
          conn_close(t, c);
          continue;
        }
      }
      if (evs[i].events & EPOLLIN) {
        char buf[16384];
        bool closed = false;
        for (;;) {
          ssize_t r = recv(c->fd, buf, sizeof buf, 0);
          if (r > 0) {
            c->rbuf.append(buf, (size_t)r);
          } else if (r == 0) {
            closed = true;
            break;
          } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
            break;
          } else {
            closed = true;
            break;
          }
        }
        if (closed) c->closing = true;  // respond/drain, then close
        if (!conn_process(t, c) ||
            (closed && !c->awaiting_rank && c->wbuf.empty())) {
          conn_close(t, c);
          continue;
        }
        if (closed) {
          // EOF stays level-triggered-readable: deregister EPOLLIN so
          // the loop doesn't spin while ranks/writes are outstanding
          epoll_event ev{};
          ev.events = c->want_write ? EPOLLOUT : 0;
          ev.data.u64 = c->id;
          epoll_ctl(t->ep, EPOLL_CTL_MOD, c->fd, &ev);
        }
      }
    }
  }
}

void deliver(Server* s, int thread_idx, Response&& r) {
  EventThread* t = s->threads[thread_idx];
  {
    std::lock_guard<std::mutex> lk(t->outbox_mu);
    t->outbox.push_back(std::move(r));
  }
  uint64_t one = 1;
  ssize_t ignored = write(t->wake_fd, &one, 8);
  (void)ignored;
}

// count one reply (served, host time, histogram) and hand it over
void reply(Server* s, const Pending& p, Response r) {
  uint64_t us = us_between(p.t_enq, Clock::now());
  s->host_us.fetch_add(us, std::memory_order_relaxed);
  s->host_hist[lat_bucket(us)].fetch_add(1, std::memory_order_relaxed);
  s->served++;
  deliver(s, p.thread_idx, std::move(r));
}

void assemble_and_deliver(Server* s, const Pending& p, const int32_t* idx,
                          const float* scores, int count) {
  std::shared_ptr<const std::vector<std::string>> frags;
  {
    std::lock_guard<std::mutex> lk(s->cfg_mu);
    frags = s->fragments;
  }
  std::string docs;
  docs.reserve(256 * (size_t)count + 64);
  std::string qid_esc;
  json_escape_into(p.query_id, &qid_esc);
  char num[64];
  for (int i = 0; i < count; i++) {
    int32_t ci = idx[i];
    if (ci < 0 || (size_t)ci >= frags->size()) continue;
    if (!docs.empty()) docs.push_back(',');
    docs += "{\"query_id\": \"";
    docs += qid_esc;
    snprintf(num, sizeof num, "\", \"rank\": %d, ", i + 1);
    docs += num;
    docs += (*frags)[ci];
    float sc = scores[i];
    if (!(sc == sc) || sc > 3.4e38f || sc < -3.4e38f) sc = 0.0f;  // finite
    snprintf(num, sizeof num, ", \"score\": %.6g}", (double)sc);
    docs += num;
  }
  std::string body = "{\"llm_response\": \"\", \"documents\": [" + docs + "]}";
  Response r;
  r.conn_id = p.conn_id;
  r.body = make_response(body);
  reply(s, p, std::move(r));
}

void dispatcher_loop(Server* s) {
  std::vector<Pending> batch;
  std::vector<const char*> qptrs;
  std::vector<int32_t> out_idx;
  std::vector<float> out_scores;
  std::vector<int32_t> out_counts;
  while (s->running.load(std::memory_order_relaxed)) {
    batch.clear();
    {
      std::unique_lock<std::mutex> lk(s->q_mu);
      s->q_cv.wait_for(lk, std::chrono::milliseconds(50),
                       [&] { return !s->queue.empty() || !s->running; });
      if (!s->running) break;
      if (s->queue.empty()) continue;
      // drain what's here; if below max_batch, wait the batch window for
      // stragglers (coalescing, serving/batcher.py semantics)
      while (!s->queue.empty() && (int)batch.size() < s->max_batch) {
        batch.push_back(std::move(s->queue.front()));
        s->queue.pop_front();
      }
      if ((int)batch.size() < s->max_batch && s->batch_window_us > 0) {
        s->q_cv.wait_for(lk, std::chrono::microseconds(s->batch_window_us));
        while (!s->queue.empty() && (int)batch.size() < s->max_batch) {
          batch.push_back(std::move(s->queue.front()));
          s->queue.pop_front();
        }
      }
    }
    int n = (int)batch.size();
    auto taken = Clock::now();
    uint64_t wait_us = 0;
    for (auto& p : batch) wait_us += us_between(p.t_enq, taken);
    s->queue_wait_us.fetch_add(wait_us, std::memory_order_relaxed);
    s->queued += (uint64_t)n;
    s->batches++;
    s->batched_queries += (uint64_t)n;
    // one top_k per batch: the max requested (extra rows are free on
    // device; each response slices its own count)
    int top_k = 1;
    for (auto& p : batch) top_k = std::max(top_k, p.top_k);
    out_idx.assign((size_t)n * top_k, -1);
    out_scores.assign((size_t)n * top_k, 0.f);
    out_counts.assign(n, 0);
    // snapshot the rank target per batch: set_rank_callback may swap it
    // at runtime (index reload) while this loop is live
    rank_cb_t cb;
    void* user;
    {
      std::lock_guard<std::mutex> lk(s->cfg_mu);
      cb = s->rank_cb;
      user = s->rank_user;
    }
    if (cb) {
      qptrs.clear();
      for (auto& p : batch) qptrs.push_back(p.query.c_str());
      int rc = cb(qptrs.data(), n, top_k, out_idx.data(),
                  out_scores.data(), out_counts.data(), user);
      if (rc != 0) {
        for (auto& p : batch) {
          Response r;
          r.conn_id = p.conn_id;
          r.body = make_response("{\"error\": \"rank failed\"}", 500,
                                 "Internal Server Error");
          reply(s, p, std::move(r));
        }
        continue;
      }
    } else {
      // stub mode: canned top-k for every query
      std::lock_guard<std::mutex> lk(s->cfg_mu);
      int k = (int)s->stub_idx.size();
      for (int i = 0; i < n; i++) {
        int c = std::min(k, batch[i].top_k);
        for (int j = 0; j < c; j++) {
          out_idx[(size_t)i * top_k + j] = s->stub_idx[j];
          out_scores[(size_t)i * top_k + j] = s->stub_scores[j];
        }
        out_counts[i] = c;
      }
    }
    for (int i = 0; i < n; i++) {
      int c = std::min(out_counts[i], batch[i].top_k);
      assemble_and_deliver(s, batch[i], &out_idx[(size_t)i * top_k],
                           &out_scores[(size_t)i * top_k], c);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* msetpu_http_create(int port, int n_threads, int max_batch,
                         int batch_window_us, int default_top_k) {
  Server* s = new Server();
  s->port = port;
  s->n_threads = std::max(1, n_threads);
  s->max_batch = std::max(1, max_batch);
  s->batch_window_us = batch_window_us;
  s->default_top_k = default_top_k;
  return s;
}

void msetpu_http_set_rank_callback(void* h, rank_cb_t cb, void* user) {
  Server* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->cfg_mu);
  s->rank_cb = cb;
  s->rank_user = user;
}

// Pipeline depth = number of concurrent dispatcher threads (call BEFORE
// start).  Depth D keeps up to D device batches in flight: the rank
// callback's device wait releases the GIL, so dispatcher k+1 preps and
// dispatches while dispatcher k waits — hiding the device round trip.
void msetpu_http_set_pipeline(void* h, int depth) {
  Server* s = (Server*)h;
  s->n_dispatchers = std::max(1, depth);
}

void msetpu_http_set_stub(void* h, const int32_t* idx, const float* scores,
                          int k) {
  Server* s = (Server*)h;
  std::lock_guard<std::mutex> lk(s->cfg_mu);
  s->stub_idx.assign(idx, idx + k);
  s->stub_scores.assign(scores, scores + k);
  s->rank_cb = nullptr;
}

// fragments: n NUL-terminated pre-escaped inner-JSON strings, indexed by
// global chunk id.  Swappable while serving (index reload): in-flight
// responses keep the shared_ptr generation they snapshotted.
void msetpu_http_load_fragments(void* h, const char** frags, int n) {
  Server* s = (Server*)h;
  auto next =
      std::make_shared<const std::vector<std::string>>(frags, frags + n);
  std::lock_guard<std::mutex> lk(s->cfg_mu);
  s->fragments = std::move(next);
}

int msetpu_http_start(void* h) {
  Server* s = (Server*)h;
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)s->port);
  if (bind(fd, (sockaddr*)&addr, sizeof addr) != 0) {
    close(fd);
    return -2;
  }
  if (listen(fd, 1024) != 0) {
    close(fd);
    return -3;
  }
  s->listen_fd = fd;
  s->running = true;
  for (int i = 0; i < s->n_threads; i++) {
    EventThread* t = new EventThread();
    t->srv = s;
    t->idx = i;
    t->ep = epoll_create1(0);
    t->wake_fd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLEXCLUSIVE;
    ev.data.u64 = 0;  // listen marker
    epoll_ctl(t->ep, EPOLL_CTL_ADD, s->listen_fd, &ev);
    epoll_event we{};
    we.events = EPOLLIN;
    we.data.u64 = 1;  // wake marker
    epoll_ctl(t->ep, EPOLL_CTL_ADD, t->wake_fd, &we);
    s->threads.push_back(t);
  }
  for (auto* t : s->threads) t->th = std::thread(event_loop, t);
  for (int i = 0; i < std::max(1, s->n_dispatchers); i++)
    s->dispatchers.emplace_back(dispatcher_loop, s);
  return 0;
}

void msetpu_http_stop(void* h) {
  Server* s = (Server*)h;
  if (!s->running.exchange(false)) return;
  s->q_cv.notify_all();
  for (auto& d : s->dispatchers) {
    if (d.joinable()) d.join();
  }
  s->dispatchers.clear();
  for (auto* t : s->threads) {
    if (t->th.joinable()) t->th.join();
  }
  for (auto* t : s->threads) {
    for (auto& kv : t->conns) {
      close(kv.second->fd);
      delete kv.second;
    }
    t->conns.clear();
    close(t->ep);
    close(t->wake_fd);
    delete t;
  }
  s->threads.clear();
  if (s->listen_fd >= 0) close(s->listen_fd);
  s->listen_fd = -1;
}

void msetpu_http_destroy(void* h) {
  msetpu_http_stop(h);
  delete (Server*)h;
}

char* msetpu_http_stats_json(void* h) {
  Server* s = (Server*)h;
  uint64_t counts[kLatBuckets];
  uint64_t n = 0;
  for (int i = 0; i < kLatBuckets; i++) {
    counts[i] = s->host_hist[i].load(std::memory_order_relaxed);
    n += counts[i];
  }
  // the bucket of the value at rank floor(q * (n - 1)) of the sorted
  // latencies, read at its geometric middle
  auto pct = [&](double q) -> double {
    if (n == 0) return 0.0;
    uint64_t rank = (uint64_t)(q * (double)(n - 1)), seen = 0;
    int i = 0;
    while (i < kLatBuckets - 1 && seen + counts[i] <= rank) seen += counts[i++];
    return std::exp2((i + 0.5) / kLatPerOctave) / 1000.0;
  };
  char buf[1024];
  snprintf(buf, sizeof buf,
           "{\"served\": %llu, \"batches\": %llu, \"batched_queries\": %llu, "
           "\"bad_requests\": %llu, \"health\": %llu, "
           "\"queued\": %llu, \"queue_wait_us\": %llu, \"host_us\": %llu, "
           "\"host_p50_ms\": %.3f, \"host_p95_ms\": %.3f, "
           "\"host_p99_ms\": %.3f}",
           (unsigned long long)s->served.load(),
           (unsigned long long)s->batches.load(),
           (unsigned long long)s->batched_queries.load(),
           (unsigned long long)s->bad_requests.load(),
           (unsigned long long)s->health_hits.load(),
           (unsigned long long)s->queued.load(),
           (unsigned long long)s->queue_wait_us.load(),
           (unsigned long long)s->host_us.load(), pct(0.5), pct(0.95),
           pct(0.99));
  return strdup(buf);
}

void msetpu_http_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// epoll load-generator client (keep-alive, n_conns in flight)
// Returns a malloc'd JSON stats string; caller frees with msetpu_http_free.
// ---------------------------------------------------------------------------

char* msetpu_http_client_bench_multi(int port, int n_conns,
                                     long total_requests,
                                     const char** bodies, int n_bodies,
                                     int timeout_s) {
  // pre-render one full request per distinct body; requests rotate over
  // them so varied-query workloads (realistic batcher/U-dedup shapes)
  // are measurable without per-request formatting cost
  std::vector<std::string> reqs;
  if (bodies == nullptr || n_bodies <= 0) {
    static const char* kDefault = "{\"query\": \"bench query\"}";
    bodies = &kDefault;
    n_bodies = 1;
  }
  reqs.reserve((size_t)n_bodies);
  for (int i = 0; i < n_bodies; i++) {
    std::string payload = bodies[i] ? bodies[i] : "{}";
    reqs.push_back(
        "POST /api/search HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        "Content-Type: application/json\r\nContent-Length: " +
        std::to_string(payload.size()) +
        "\r\nConnection: keep-alive\r\n\r\n" + payload);
  }

  struct CConn {
    int fd;
    std::string rbuf;
    const std::string* req = nullptr;
    size_t sent = 0;
    double t0 = 0;
    bool in_flight = false;
  };
  int ep = epoll_create1(0);
  std::vector<CConn> conns((size_t)n_conns);
  for (int i = 0; i < n_conns; i++) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)port);
    if (connect(fd, (sockaddr*)&addr, sizeof addr) != 0) {
      close(fd);
      close(ep);
      return strdup("{\"error\": \"connect failed\"}");
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    set_nonblock(fd);
    conns[(size_t)i].fd = fd;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u32 = (uint32_t)i;
    epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev);
  }
  long started = 0, done = 0, errors = 0;
  std::vector<float> lats;
  lats.reserve((size_t)std::min(total_requests, 1L << 20));
  double t_start = now_ms();
  double deadline = t_start + timeout_s * 1000.0;
  epoll_event evs[256];

  auto kick = [&](CConn& c) {
    if (started >= total_requests || c.in_flight) return;
    c.in_flight = true;
    c.req = &reqs[(size_t)(started % (long)reqs.size())];
    c.sent = 0;
    c.t0 = now_ms();
    started++;
    // send as much as possible now
    while (c.sent < c.req->size()) {
      ssize_t n = send(c.fd, c.req->data() + c.sent, c.req->size() - c.sent,
                       MSG_NOSIGNAL);
      if (n > 0) c.sent += (size_t)n;
      else break;
    }
  };
  for (auto& c : conns) kick(c);

  while (done + errors < total_requests && now_ms() < deadline) {
    int n = epoll_wait(ep, evs, 256, 100);
    for (int i = 0; i < n; i++) {
      CConn& c = conns[evs[i].data.u32];
      if (!c.in_flight) continue;
      if (evs[i].events & EPOLLOUT) {
        while (c.sent < c.req->size()) {
          ssize_t k = send(c.fd, c.req->data() + c.sent,
                           c.req->size() - c.sent, MSG_NOSIGNAL);
          if (k > 0) c.sent += (size_t)k;
          else break;
        }
      }
      if (evs[i].events & EPOLLIN) {
        char buf[16384];
        for (;;) {
          ssize_t k = recv(c.fd, buf, sizeof buf, 0);
          if (k > 0) c.rbuf.append(buf, (size_t)k);
          else break;
        }
        // complete response? headers + content-length body
        size_t he = c.rbuf.find("\r\n\r\n");
        if (he != std::string::npos) {
          size_t clen = 0;
          for (size_t p = 0; p + 15 < he; p++) {
            if (strncasecmp(c.rbuf.c_str() + p, "content-length:", 15) == 0) {
              clen = strtoul(c.rbuf.c_str() + p + 15, nullptr, 10);
              break;
            }
          }
          if (c.rbuf.size() >= he + 4 + clen) {
            bool ok = c.rbuf.compare(9, 3, "200") == 0;
            if (ok) {
              done++;
              lats.push_back((float)(now_ms() - c.t0));
            } else {
              errors++;
            }
            c.rbuf.erase(0, he + 4 + clen);
            c.in_flight = false;
            kick(c);
          }
        }
      }
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        errors++;
        c.in_flight = false;
      }
    }
  }
  double wall_s = (now_ms() - t_start) / 1000.0;
  for (auto& c : conns) close(c.fd);
  close(ep);
  std::sort(lats.begin(), lats.end());
  auto pct = [&](double q) -> double {
    if (lats.empty()) return 0.0;
    return lats[(size_t)(q * (double)(lats.size() - 1))];
  };
  char buf[512];
  snprintf(buf, sizeof buf,
           "{\"requests\": %ld, \"errors\": %ld, \"wall_s\": %.3f, "
           "\"qps\": %.1f, \"p50_ms\": %.3f, \"p95_ms\": %.3f, "
           "\"p99_ms\": %.3f, \"conns\": %d}",
           done, errors, wall_s, done / std::max(wall_s, 1e-9), pct(0.5),
           pct(0.95), pct(0.99), n_conns);
  return strdup(buf);
}

char* msetpu_http_client_bench(int port, int n_conns, long total_requests,
                               const char* body, int timeout_s) {
  const char* bodies[1] = {body};
  return msetpu_http_client_bench_multi(port, n_conns, total_requests,
                                        body ? bodies : nullptr,
                                        body ? 1 : 0, timeout_s);
}

}  // extern "C"
