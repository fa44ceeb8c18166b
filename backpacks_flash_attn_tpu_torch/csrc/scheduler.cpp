// Continuous-batching request scheduler: the native control plane of the
// serving engine (serving/engine.py). A copy of the JAX package's
// csrc/scheduler.cpp, built by serving/scheduler.py with g++ at first use.
//
// Responsibilities: FIFO admission queue, slot free-list, per-slot request
// state (emitted tokens, budgets), retirement on EOS / token budget / cache
// capacity. Deterministic and allocation-light: the hot path (on_token) is a
// few branches; it runs once per generated token per request between device
// steps, on the host thread that launches them.
//
// Exposed as a C ABI for ctypes; the Python twin in serving/scheduler.py
// implements identical semantics and the tests cross-check the two
// step for step.

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
};

struct Slot {
  int64_t request_id = -1;
  int32_t prompt_len = 0;
  int32_t max_new_tokens = 0;
  std::vector<int32_t> tokens;
  bool active = false;
};

struct Scheduler {
  int32_t max_slots;
  int32_t max_seqlen;
  int32_t eos_id;
  std::deque<Request> pending;
  std::vector<Slot> slots;
  std::vector<int32_t> free_slots;  // LIFO: reuse hot slots first
  int64_t completed = 0;

  Scheduler(int32_t ms, int32_t msl, int32_t eos)
      : max_slots(ms), max_seqlen(msl), eos_id(eos), slots(ms) {
    for (int32_t i = ms - 1; i >= 0; --i) free_slots.push_back(i);
  }
};

}  // namespace

extern "C" {

void* bpsched_new(int32_t max_slots, int32_t max_seqlen, int32_t eos_id) {
  return new Scheduler(max_slots, max_seqlen, eos_id);
}

void bpsched_free(void* h) { delete static_cast<Scheduler*>(h); }

// Returns 0 on accept, -1 if the prompt can never fit (prompt_len + 1 decode
// step would overflow the cache).
int32_t bpsched_submit(void* h, int64_t request_id, int32_t prompt_len,
                       int32_t max_new_tokens) {
  auto* s = static_cast<Scheduler*>(h);
  if (prompt_len <= 0 || prompt_len + 1 > s->max_seqlen) return -1;
  s->pending.push_back({request_id, prompt_len, max_new_tokens});
  return 0;
}

int32_t bpsched_num_pending(void* h) {
  return static_cast<int32_t>(static_cast<Scheduler*>(h)->pending.size());
}

int32_t bpsched_num_active(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int32_t n = 0;
  for (const auto& sl : s->slots) n += sl.active ? 1 : 0;
  return n;
}

int64_t bpsched_completed(void* h) {
  return static_cast<Scheduler*>(h)->completed;
}

// Pops the next pending request into a free slot. Returns the slot index, or
// -1 when there is nothing to admit / no free slot. The caller then prefills
// that slot on the device.
int32_t bpsched_admit(void* h, int64_t* request_id_out,
                      int32_t* prompt_len_out) {
  auto* s = static_cast<Scheduler*>(h);
  if (s->pending.empty() || s->free_slots.empty()) return -1;
  int32_t slot = s->free_slots.back();
  s->free_slots.pop_back();
  Request r = s->pending.front();
  s->pending.pop_front();
  Slot& sl = s->slots[slot];
  sl.request_id = r.id;
  sl.prompt_len = r.prompt_len;
  sl.max_new_tokens = r.max_new_tokens;
  sl.tokens.clear();
  sl.active = true;
  *request_id_out = r.id;
  *prompt_len_out = r.prompt_len;
  return slot;
}

// Records one generated token. Returns 1 if the request just finished
// (EOS, token budget, or cache capacity), 0 if it continues, -1 on a bad or
// inactive slot. A finished slot stays readable until bpsched_release.
int32_t bpsched_on_token(void* h, int32_t slot, int32_t token) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots || !s->slots[slot].active) return -1;
  Slot& sl = s->slots[slot];
  sl.tokens.push_back(token);
  const int32_t emitted = static_cast<int32_t>(sl.tokens.size());
  const bool done = token == s->eos_id ||
                    emitted >= sl.max_new_tokens ||
                    sl.prompt_len + emitted >= s->max_seqlen;
  if (done) {
    sl.active = false;
    s->completed += 1;
    return 1;
  }
  return 0;
}

int64_t bpsched_slot_request(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots) return -1;
  return s->slots[slot].request_id;
}

int32_t bpsched_slot_num_tokens(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots) return -1;
  return static_cast<int32_t>(s->slots[slot].tokens.size());
}

int32_t bpsched_slot_tokens(void* h, int32_t slot, int32_t* out,
                            int32_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots) return -1;
  const auto& t = s->slots[slot].tokens;
  const int32_t n = static_cast<int32_t>(t.size()) < cap
                        ? static_cast<int32_t>(t.size())
                        : cap;
  std::memcpy(out, t.data(), n * sizeof(int32_t));
  return n;
}

int32_t bpsched_slot_active(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots) return -1;
  return s->slots[slot].active ? 1 : 0;
}

// Frees the slot for reuse (after the caller has drained its tokens).
void bpsched_release(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_slots) return;
  Slot& sl = s->slots[slot];
  if (sl.request_id == -1) return;  // double-release guard
  sl.request_id = -1;
  sl.active = false;
  sl.tokens.clear();
  s->free_slots.push_back(slot);
}

}  // extern "C"
