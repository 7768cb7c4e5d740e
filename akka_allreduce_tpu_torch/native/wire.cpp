// Host data-plane wire hot loop: payload-frame header pack/unpack + checksum.
//
// The Python codec (control/wire.py) frames float payloads as
//   [tag u8][fields][count_word u32][checksum u32][payload bytes]
// where tag 2 = ScatterBlock (fields <iiiq>), tag 3 = ReduceBlock (<iiiqi>),
// the count word's top bit flags a float16 payload, and the checksum is the
// additive sum of the payload's LE u32 words mod 2^32, tail zero-padded
// (matches native.wire_checksum's numpy fallback exactly).
//
// These two entry points collapse the per-frame Python work — struct packs,
// bounds checks, and the full-payload checksum pass — into ONE ctypes call
// each way, so the per-byte cost of a payload frame is a single vectorized
// read (the checksum) with no intermediate allocation. Byte order is written
// explicitly little-endian so the wire format is host-independent.
//
// The port's own copy of the JAX package's native/wire.cpp, built alone into
// build/native/ at first use (akka_allreduce_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

#if defined(__linux__) || defined(__APPLE__)
#define AW_HAVE_SOCKETS 1
#include <cerrno>
#include <sys/socket.h>
#include <sys/uio.h>
#endif

namespace {

inline void put_le32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v);
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

inline void put_le64(uint8_t* p, uint64_t v) {
  put_le32(p, (uint32_t)v);
  put_le32(p + 4, (uint32_t)(v >> 32));
}

inline uint32_t get_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline uint64_t get_le64(const uint8_t* p) {
  return (uint64_t)get_le32(p) | ((uint64_t)get_le32(p + 4) << 32);
}

constexpr uint32_t kF16Flag = 0x80000000u;  // wire.py _F16_FLAG

}  // namespace

extern "C" {

// Additive payload checksum: sum of little-endian u32 words mod 2^32, the
// tail (payloads are always a multiple of 2 bytes) zero-padded. A word sum
// vectorizes to memory speed — one read pass, ~8x cheaper than the memcpy
// it replaces on the old join/readexactly path — and catches the framing
// corruptions the transport actually sees (truncation, garbage bodies).
uint32_t aw_checksum(const uint8_t* data, int64_t n) {
  int64_t n4 = n >> 2;
  uint64_t s = 0;
#pragma omp parallel for schedule(static) reduction(+ : s) if (n4 > 262144)
  for (int64_t i = 0; i < n4; ++i) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    // memcpy load: one unaligned mov per word — decode checksums run at
    // payload offsets the dest-string length makes misaligned, where the
    // byte-shift form costs ~5x
    uint32_t w;
    __builtin_memcpy(&w, data + 4 * i, 4);
    s += w;
#else
    s += get_le32(data + 4 * i);
#endif
  }
  uint32_t tail = 0;
  for (int64_t i = n4 * 4, shift = 0; i < n; ++i, shift += 8)
    tail |= (uint32_t)data[i] << shift;
  return (uint32_t)(s + tail);
}

// Pack [tag][fields][count_word][checksum] for a payload frame and compute
// the checksum of `payload` in the same call. Returns the header length
// written into `out` (caller provides >= 34 bytes), or -1 on unknown tag.
int aw_pack_block(uint8_t* out, int tag, int32_t src_id, int32_t dest_id,
                  int32_t chunk_id, int64_t round_num, int32_t count,
                  const uint8_t* payload, int64_t payload_bytes,
                  uint32_t count_word) {
  if (tag != 2 && tag != 3) return -1;
  uint8_t* p = out;
  *p++ = (uint8_t)tag;
  put_le32(p, (uint32_t)src_id);
  put_le32(p + 4, (uint32_t)dest_id);
  put_le32(p + 8, (uint32_t)chunk_id);
  put_le64(p + 12, (uint64_t)round_num);
  p += 20;
  if (tag == 3) {
    put_le32(p, (uint32_t)count);
    p += 4;
  }
  put_le32(p, count_word);
  put_le32(p + 4, aw_checksum(payload, payload_bytes));
  p += 8;
  return (int)(p - out);
}

// Parse + verify a payload frame body starting at the tag byte. Fills
// out[0..6] = {src_id, dest_id, chunk_id, round_num, count, n_elems, is_f16}
// and returns the payload byte offset, or -1 (truncated) / -2 (checksum
// mismatch) / -3 (not a payload tag).
int64_t aw_unpack_block(const uint8_t* body, int64_t nbytes, int64_t* out) {
  if (nbytes < 1) return -1;
  int tag = body[0];
  if (tag != 2 && tag != 3) return -3;
  int64_t off = 1 + 20 + (tag == 3 ? 4 : 0) + 8;  // fields + count word + checksum
  if (nbytes < off) return -1;
  const uint8_t* p = body + 1;
  out[0] = (int32_t)get_le32(p);
  out[1] = (int32_t)get_le32(p + 4);
  out[2] = (int32_t)get_le32(p + 8);
  out[3] = (int64_t)get_le64(p + 12);
  out[4] = tag == 3 ? (int32_t)get_le32(p + 20) : 0;
  uint32_t count_word = get_le32(body + off - 8);
  uint32_t checksum = get_le32(body + off - 4);
  int is_f16 = (count_word & kF16Flag) != 0;
  int64_t n_elems = (int64_t)(count_word & ~kF16Flag);
  out[5] = n_elems;
  out[6] = is_f16;
  int64_t payload_bytes = n_elems * (is_f16 ? 2 : 4);
  if (payload_bytes > nbytes - off) return -1;
  if (aw_checksum(body + off, payload_bytes) != checksum) return -2;
  return off;
}

}  // extern "C"

// -- batch syscalls (multi-stream data plane, BENCHMARKS.md round 8) ---------
//
// One coalesced burst of frames drains in ONE syscall per stream:
// `aw_sendmmsg` maps a (bases, lens, counts) flattening of per-frame iovec
// lists onto Linux's sendmmsg(2) — message m owns counts[m] consecutive
// iovecs — and `aw_recvmmsg` is its receive-side mirror over recvmmsg(2).
// Neither changes a single wire byte: batching is pure syscall coalescing,
// and the plain sendmsg/recvmsg LOOP fallback below is compiled in
// unconditionally and selected at RUNTIME (first-call ENOSYS probe, or
// use_fallback=1 for tests pinning byte-identical output). Both return
// total bytes moved (callers advance their views and re-enter — short
// counts and partial trailing messages are normal on stream sockets), or
// -errno when nothing moved.

#if AW_HAVE_SOCKETS
namespace {

constexpr int kMaxBatchMsgs = 64;
constexpr int kMaxBatchIovs = 1024;

int64_t sendmsg_loop(int fd, const uint64_t* bases, const int64_t* lens,
                     const int32_t* counts, int32_t nmsgs) {
  int64_t total = 0;
  int64_t iov_off = 0;
  for (int32_t m = 0; m < nmsgs; ++m) {
    struct iovec iov[kMaxBatchIovs];
    int32_t cnt = counts[m];
    if (cnt > kMaxBatchIovs) return total > 0 ? total : -EINVAL;
    int64_t want = 0;
    for (int32_t i = 0; i < cnt; ++i) {
      iov[i].iov_base = (void*)(uintptr_t)bases[iov_off + i];
      iov[i].iov_len = (size_t)lens[iov_off + i];
      want += lens[iov_off + i];
    }
    struct msghdr hdr;
    memset(&hdr, 0, sizeof(hdr));
    hdr.msg_iov = iov;
    hdr.msg_iovlen = cnt;
    ssize_t n = sendmsg(fd, &hdr, 0);
    if (n < 0) return total > 0 ? total : -(int64_t)errno;
    total += n;
    if (n < want) break;  // kernel buffer full mid-frame: caller re-enters
    iov_off += cnt;
  }
  return total;
}

}  // namespace
#endif  // AW_HAVE_SOCKETS

extern "C" {

// 1 iff the running kernel implements sendmmsg/recvmmsg (runtime probe, not
// a compile-time guess — the batch path must degrade on kernels/libcs that
// compiled fine but answer ENOSYS).
int aw_have_sendmmsg(void) {
#if defined(__linux__)
  static int cached = -1;
  if (cached < 0) {
    struct mmsghdr hdr;
    memset(&hdr, 0, sizeof(hdr));
    // fd -1 never touches a real socket: an implemented syscall answers
    // EBADF, an unimplemented one ENOSYS
    int r = sendmmsg(-1, &hdr, 1, 0);
    cached = (r >= 0 || errno != ENOSYS) ? 1 : 0;
  }
  return cached;
#else
  return 0;
#endif
}

// Batch send: nmsgs messages, message m owning counts[m] iovecs taken in
// order from (bases, lens). Returns total bytes written, or -errno when
// nothing was written. use_fallback != 0 forces the sendmsg loop.
int64_t aw_sendmmsg(int fd, const uint64_t* bases, const int64_t* lens,
                    const int32_t* counts, int32_t nmsgs,
                    int32_t use_fallback) {
#if !AW_HAVE_SOCKETS
  (void)fd; (void)bases; (void)lens; (void)counts; (void)nmsgs;
  (void)use_fallback;
  return -38;  // ENOSYS
#else
  if (nmsgs <= 0) return 0;
#if defined(__linux__)
  if (!use_fallback && aw_have_sendmmsg()) {
    struct mmsghdr hdrs[kMaxBatchMsgs];
    struct iovec iov[kMaxBatchIovs];
    int32_t n = nmsgs < kMaxBatchMsgs ? nmsgs : kMaxBatchMsgs;
    int64_t iov_off = 0;
    int32_t built = 0;
    for (; built < n; ++built) {
      int32_t cnt = counts[built];
      if (iov_off + cnt > kMaxBatchIovs) break;
      memset(&hdrs[built], 0, sizeof(hdrs[built]));
      for (int32_t i = 0; i < cnt; ++i) {
        iov[iov_off + i].iov_base = (void*)(uintptr_t)bases[iov_off + i];
        iov[iov_off + i].iov_len = (size_t)lens[iov_off + i];
      }
      hdrs[built].msg_hdr.msg_iov = &iov[iov_off];
      hdrs[built].msg_hdr.msg_iovlen = cnt;
      iov_off += cnt;
    }
    if (built > 0) {
      int r = sendmmsg(fd, hdrs, built, 0);
      if (r < 0) return -(int64_t)errno;
      int64_t total = 0;
      for (int i = 0; i < r; ++i) total += (int64_t)hdrs[i].msg_len;
      return total;
    }
    // first message alone overflows the iovec budget: fall through
  }
#endif  // __linux__
  return sendmsg_loop(fd, bases, lens, counts, nmsgs);
#endif  // AW_HAVE_SOCKETS
}

}  // extern "C"

// -- io_uring batch submission (data plane v3, BENCHMARKS.md round 9) --------
//
// The next syscall step past `sendmmsg`: a sender thread drains its whole
// burst through ONE ring submission — a single IORING_OP_SENDMSG whose iovec
// array gathers every frame segment of the batch (one msghdr, so the TCP
// byte stream can never interleave; linked-SQE chains are deliberately NOT
// used — a short send mid-chain would let a later message's bytes land
// after a partial earlier one). Wire bytes are identical to the
// sendmmsg/sendmsg paths; like them, this is pure submission mechanics.
//
// Everything io_uring is defined locally (struct layouts are kernel ABI,
// stable by contract) so this compiles against pre-5.1 kernel headers; the
// RUNTIME probe decides whether it runs: io_uring_setup answering ENOSYS
// (old kernel), EPERM (seccomp/gVisor), or a registration probe without
// SENDMSG support all fall through to the sendmmsg/sendmsg path, and the
// probe's errno is exported so bench-wire can RECORD the fallback reason.

#if defined(__linux__)
#include <new>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif
#ifndef __NR_io_uring_register
#define __NR_io_uring_register 427
#endif

namespace {

// kernel ABI mirrors (include/uapi/linux/io_uring.h) — local names so a
// host that DOES ship the header cannot clash
struct aw_sqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array, resv1;
  uint64_t resv2;
};
struct aw_cqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes, flags, resv1;
  uint64_t resv2;
};
struct aw_uring_params {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle;
  uint32_t features, wq_fd, resv[3];
  struct aw_sqring_offsets sq_off;
  struct aw_cqring_offsets cq_off;
};
struct aw_uring_sqe {  // 64 bytes, exact kernel layout
  uint8_t opcode;
  uint8_t flags;
  uint16_t ioprio;
  int32_t fd;
  uint64_t off;
  uint64_t addr;
  uint32_t len;
  uint32_t msg_flags;  // union: rw_flags/fsync_flags/... — SENDMSG uses this
  uint64_t user_data;
  uint64_t pad2[3];
};
struct aw_uring_cqe {
  uint64_t user_data;
  int32_t res;
  uint32_t flags;
};
struct aw_uring_probe_op {
  uint8_t op, resv;
  uint16_t flags;  // bit 0 = IO_URING_OP_SUPPORTED
  uint32_t resv2;
};
struct aw_uring_probe {
  uint8_t last_op, ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  struct aw_uring_probe_op ops[64];
};

constexpr uint8_t kOpSendmsg = 9;       // IORING_OP_SENDMSG
constexpr unsigned kEnterGetevents = 1; // IORING_ENTER_GETEVENTS
constexpr unsigned kRegisterProbe = 8;  // IORING_REGISTER_PROBE
constexpr uint32_t kFeatSingleMmap = 1; // IORING_FEAT_SINGLE_MMAP
constexpr off_t kOffSqRing = 0;
constexpr off_t kOffCqRing = 0x8000000;
constexpr off_t kOffSqes = 0x10000000;

struct AwUring {
  int ring_fd;
  int broken;  // an op was left in flight on an error path: never reuse
  unsigned sq_entries, cq_entries;
  unsigned *sq_head, *sq_tail, *sq_mask, *sq_array;
  unsigned *cq_head, *cq_tail, *cq_mask;
  struct aw_uring_sqe* sqes;
  struct aw_uring_cqe* cq_cqes;
  void *sq_ptr, *cq_ptr;
  size_t sq_len, cq_len, sqes_len;
  int single_mmap;
};

int aw_uring_probe_errno_ = -1;  // -1 = not probed; 0 = supported

int uring_setup(unsigned entries, struct aw_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
int uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, nullptr, 0);
}

}  // namespace
#endif  // __linux__

extern "C" {

// 1 iff the running kernel accepts io_uring_setup AND (when the kernel can
// answer) reports IORING_OP_SENDMSG supported. The verdict and the errno
// behind a negative one are cached; aw_uring_probe_errno() exports the
// reason (0 = supported, ENOSYS = pre-5.1 kernel, EPERM = seccomp/gVisor
// policy, EOPNOTSUPP = ring works but SENDMSG is not implemented).
int aw_have_uring(void) {
#if defined(__linux__)
  if (aw_uring_probe_errno_ >= 0) return aw_uring_probe_errno_ == 0;
  struct aw_uring_params params;
  memset(&params, 0, sizeof(params));
  int fd = uring_setup(4, &params);
  if (fd < 0) {
    aw_uring_probe_errno_ = errno ? errno : ENOSYS;
    return 0;
  }
  // SENDMSG needs kernel >= 5.3; the registration probe (>= 5.6) answers
  // authoritatively. A kernel too old for the probe op (EINVAL) but new
  // enough for io_uring is assumed capable — a 5.1/5.2 kernel would fail
  // the first real submit with EINVAL, which the caller latches into the
  // same fallback path at runtime.
  struct aw_uring_probe probe;
  memset(&probe, 0, sizeof(probe));
  long r = syscall(__NR_io_uring_register, fd, kRegisterProbe, &probe, 64);
  if (r == 0 &&
      (probe.last_op < kOpSendmsg || !(probe.ops[kOpSendmsg].flags & 1))) {
    aw_uring_probe_errno_ = EOPNOTSUPP;
  } else {
    aw_uring_probe_errno_ = 0;
  }
  close(fd);
  return aw_uring_probe_errno_ == 0;
#else
  return 0;
#endif
}

// The probe's verdict as an errno (0 = io_uring usable; see aw_have_uring).
int aw_uring_probe_errno(void) {
#if defined(__linux__)
  aw_have_uring();
  return aw_uring_probe_errno_;
#else
  return 38;  // ENOSYS
#endif
}

// Create a submission ring (or NULL — caller falls back). One ring per
// sender thread; rings are not thread-safe and never shared.
void* aw_uring_create(int entries) {
#if defined(__linux__)
  if (!aw_have_uring()) return nullptr;
  if (entries < 1) entries = 1;
  struct aw_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = uring_setup((unsigned)entries, &p);
  if (fd < 0) return nullptr;
  AwUring* r = new (std::nothrow) AwUring;
  if (!r) {
    close(fd);
    return nullptr;
  }
  memset(r, 0, sizeof(*r));
  r->ring_fd = fd;
  r->sq_entries = p.sq_entries;
  r->cq_entries = p.cq_entries;
  r->single_mmap = (p.features & kFeatSingleMmap) != 0;
  r->sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  r->cq_len = p.cq_off.cqes + p.cq_entries * sizeof(struct aw_uring_cqe);
  if (r->single_mmap && r->cq_len > r->sq_len) r->sq_len = r->cq_len;
  r->sq_ptr = mmap(nullptr, r->sq_len, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, kOffSqRing);
  if (r->sq_ptr == MAP_FAILED) goto fail;
  if (r->single_mmap) {
    r->cq_ptr = r->sq_ptr;
    r->cq_len = r->sq_len;
  } else {
    r->cq_ptr = mmap(nullptr, r->cq_len, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, fd, kOffCqRing);
    if (r->cq_ptr == MAP_FAILED) {
      r->cq_ptr = nullptr;
      goto fail;
    }
  }
  r->sqes_len = p.sq_entries * sizeof(struct aw_uring_sqe);
  r->sqes = (struct aw_uring_sqe*)mmap(nullptr, r->sqes_len,
                                       PROT_READ | PROT_WRITE,
                                       MAP_SHARED | MAP_POPULATE, fd,
                                       kOffSqes);
  if (r->sqes == MAP_FAILED) {
    r->sqes = nullptr;
    goto fail;
  }
  {
    uint8_t* sq = (uint8_t*)r->sq_ptr;
    uint8_t* cq = (uint8_t*)r->cq_ptr;
    r->sq_head = (unsigned*)(sq + p.sq_off.head);
    r->sq_tail = (unsigned*)(sq + p.sq_off.tail);
    r->sq_mask = (unsigned*)(sq + p.sq_off.ring_mask);
    r->sq_array = (unsigned*)(sq + p.sq_off.array);
    r->cq_head = (unsigned*)(cq + p.cq_off.head);
    r->cq_tail = (unsigned*)(cq + p.cq_off.tail);
    r->cq_mask = (unsigned*)(cq + p.cq_off.ring_mask);
    r->cq_cqes = (struct aw_uring_cqe*)(cq + p.cq_off.cqes);
  }
  return r;
fail:
  if (r->sq_ptr && r->sq_ptr != MAP_FAILED) munmap(r->sq_ptr, r->sq_len);
  if (!r->single_mmap && r->cq_ptr) munmap(r->cq_ptr, r->cq_len);
  close(fd);
  delete r;
  return nullptr;
#else
  (void)entries;
  return nullptr;
#endif
}

void aw_uring_close(void* ring) {
#if defined(__linux__)
  if (!ring) return;
  AwUring* r = (AwUring*)ring;
  if (r->sqes) munmap(r->sqes, r->sqes_len);
  if (r->sq_ptr) munmap(r->sq_ptr, r->sq_len);
  if (!r->single_mmap && r->cq_ptr) munmap(r->cq_ptr, r->cq_len);
  close(r->ring_fd);
  delete r;
#else
  (void)ring;
#endif
}

// One burst, one ring submission: gather (bases, lens) into a single
// msghdr/SENDMSG SQE and wait for its completion. Returns bytes sent
// (short counts normal — the caller advances and re-enters), or -errno.
int64_t aw_uring_sendmsg(void* ring, int fd, const uint64_t* bases,
                         const int64_t* lens, int32_t niov) {
#if !defined(__linux__)
  (void)ring; (void)fd; (void)bases; (void)lens; (void)niov;
  return -38;  // ENOSYS
#else
  if (!ring) return -EINVAL;
  if (niov <= 0) return 0;
  AwUring* r = (AwUring*)ring;
  if (r->broken) return -EOPNOTSUPP;  // poisoned: caller latches off
  struct iovec iov[kMaxBatchIovs];
  int32_t n = niov < kMaxBatchIovs ? niov : kMaxBatchIovs;
  for (int32_t i = 0; i < n; ++i) {
    iov[i].iov_base = (void*)(uintptr_t)bases[i];
    iov[i].iov_len = (size_t)lens[i];
  }
  struct msghdr hdr;
  memset(&hdr, 0, sizeof(hdr));
  hdr.msg_iov = iov;
  hdr.msg_iovlen = n;
  unsigned tail = __atomic_load_n(r->sq_tail, __ATOMIC_RELAXED);
  unsigned idx = tail & *r->sq_mask;
  struct aw_uring_sqe* sqe = &r->sqes[idx];
  memset(sqe, 0, sizeof(*sqe));
  sqe->opcode = kOpSendmsg;
  sqe->fd = fd;
  sqe->addr = (uint64_t)(uintptr_t)&hdr;
  sqe->len = 1;
  // MSG_DONTWAIT is load-bearing twice over: a full socket buffer answers
  // -EAGAIN instead of parking this op in io-wq (where SO_SNDTIMEO does
  // not apply — a stalled peer would hang the sender thread in an
  // uninterruptible enter, defeating the caller's bounded-select pacing
  // and teardown joins), and a non-blocking op completes inline at
  // submit, so the completion wait below is one pass in practice.
  sqe->msg_flags = MSG_NOSIGNAL | MSG_DONTWAIT;
  sqe->user_data = tail;
  r->sq_array[idx] = idx;
  __atomic_store_n(r->sq_tail, tail + 1, __ATOMIC_RELEASE);
  // Submit + wait, retrying interrupted waits: the op references THIS
  // stack frame's msghdr/iov, so returning before its CQE is reaped
  // would leave the kernel reading dead stack AND make the Python
  // caller's retry duplicate bytes on the TCP stream. -EINTR before the
  // SQE was consumed re-enters with to_submit=1 (the ring still holds
  // it); after consumption a bare GETEVENTS wait suffices.
  for (;;) {
    int submitted = uring_enter(r->ring_fd, 1, 1, kEnterGetevents);
    if (submitted >= 0) break;
    unsigned sq_head = __atomic_load_n(r->sq_head, __ATOMIC_ACQUIRE);
    if (errno != EINTR) {
      if (sq_head == tail + 1) {
        // the SQE was consumed but its completion cannot be awaited:
        // the op may still reference this stack frame — poison the ring
        // so no later call can desync against the orphan
        r->broken = 1;
      } else {
        // not consumed: rewind our tail advance, or the NEXT call's
        // to_submit=1 would submit this call's stale SQE (whose iovecs
        // point at a dead stack frame) and misattribute its completion
        __atomic_store_n(r->sq_tail, tail, __ATOMIC_RELEASE);
      }
      return -(int64_t)errno;
    }
    if (sq_head == tail + 1) break;  // consumed: fall through to the wait
  }
  for (;;) {
    unsigned head = __atomic_load_n(r->cq_head, __ATOMIC_RELAXED);
    unsigned cq_tail = __atomic_load_n(r->cq_tail, __ATOMIC_ACQUIRE);
    if (head != cq_tail) {
      struct aw_uring_cqe* cqe = &r->cq_cqes[head & *r->cq_mask];
      int64_t res = cqe->res;
      __atomic_store_n(r->cq_head, head + 1, __ATOMIC_RELEASE);
      return res;  // >0 bytes, or the op's -errno (-EAGAIN = buffer full)
    }
    int w = uring_enter(r->ring_fd, 0, 1, kEnterGetevents);
    if (w < 0 && errno != EINTR) {
      r->broken = 1;  // op in flight, wait impossible: poison (see above)
      return -(int64_t)errno;
    }
  }
#endif
}

}  // extern "C"

extern "C" {

// Batch receive: fill up to nbufs buffers (one iovec each) in order.
// Returns total bytes read (a short tail buffer is normal on stream
// sockets), 0 on orderly EOF, or -errno when nothing was read.
int64_t aw_recvmmsg(int fd, const uint64_t* bases, const int64_t* lens,
                    int32_t nbufs, int32_t use_fallback) {
#if !AW_HAVE_SOCKETS
  (void)fd; (void)bases; (void)lens; (void)nbufs; (void)use_fallback;
  return -38;  // ENOSYS
#else
  if (nbufs <= 0) return 0;
#if defined(__linux__)
  // Some kernels and container runtimes (e.g. gVisor) implement recvmmsg but reject
  // MSG_WAITFORONE with EINVAL — a second RUNTIME probe, cached like the
  // ENOSYS one: first EINVAL answer routes every later call to the loop.
  static int waitforone_broken = 0;
  if (!use_fallback && !waitforone_broken && aw_have_sendmmsg()) {
    struct mmsghdr hdrs[kMaxBatchMsgs];
    struct iovec iov[kMaxBatchMsgs];
    int32_t n = nbufs < kMaxBatchMsgs ? nbufs : kMaxBatchMsgs;
    for (int32_t i = 0; i < n; ++i) {
      iov[i].iov_base = (void*)(uintptr_t)bases[i];
      iov[i].iov_len = (size_t)lens[i];
      memset(&hdrs[i], 0, sizeof(hdrs[i]));
      hdrs[i].msg_hdr.msg_iov = &iov[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
    }
    // MSG_WAITFORONE: block for the FIRST message only — on a blocking
    // socket a bare recvmmsg would otherwise wait for all n, hanging a
    // caller whose stream holds fewer bytes than the buffer set
    int r = recvmmsg(fd, hdrs, n, MSG_WAITFORONE, nullptr);
    if (r >= 0) {
      int64_t total = 0;
      for (int i = 0; i < r; ++i) total += (int64_t)hdrs[i].msg_len;
      return total;
    }
    if (errno != EINVAL) return -(int64_t)errno;
    waitforone_broken = 1;  // fall through to the recvmsg loop
  }
#endif  // __linux__
  int64_t total = 0;
  for (int32_t i = 0; i < nbufs; ++i) {
    struct iovec one;
    one.iov_base = (void*)(uintptr_t)bases[i];
    one.iov_len = (size_t)lens[i];
    struct msghdr hdr;
    memset(&hdr, 0, sizeof(hdr));
    hdr.msg_iov = &one;
    hdr.msg_iovlen = 1;
    // mirror MSG_WAITFORONE: only the first recv may block
    ssize_t got = recvmsg(fd, &hdr, i == 0 ? 0 : MSG_DONTWAIT);
    if (got < 0) {
      if (total > 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
        return total;
      return total > 0 ? total : -(int64_t)errno;
    }
    total += got;
    if (got < (ssize_t)one.iov_len) break;  // short read: stream drained
  }
  return total;
#endif  // AW_HAVE_SOCKETS
}

}  // extern "C"
