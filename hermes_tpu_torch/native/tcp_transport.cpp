// TCP net-transport core (SURVEY.md §2 "Net-transport: tcp", §5.8).
//
// The reference's transport plugin layer moves INV/ACK/VAL batches between
// replicas; its `tcp` backend is a socket implementation behind the same
// interface as `rdma`.  This is the rebuild's native equivalent: a small
// C++ full-mesh exchanger doing step-synchronous block exchange between
// replica processes.  The Python side (transport/tcp.py) binds it
// with ctypes and adapts it to the HostTransport interface.
//
// Design: one listening socket per rank at base_port+rank; every ordered
// pair (i -> j) communicates over the connection i dialed to j.  An exchange
// sends one length-prefixed block to every peer (a sender thread per peer,
// so large blocks cannot deadlock against full send buffers) and receives
// exactly one block from every peer.  TCP gives per-edge FIFO + reliability,
// matching the sim transport's channel semantics with zero-step delay.
//
// Build: g++ -O2 -shared -fPIC -o libhermes_tcp.so tcp_transport.cpp -pthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Mesh {
  int my_rank = 0;
  int n_ranks = 0;
  // fds[r]: the socket carrying traffic between this rank and rank r
  // (for r == my_rank, -1: self-delivery is done in Python by memcpy).
  std::vector<int> fds;
  int listen_fd = -1;
};

int set_common_opts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return 0;
}

bool send_all(int fd, const uint8_t* buf, size_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, buf, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      return false;
    }
    buf += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, uint8_t* buf, size_t n) {
  while (n > 0) {
    ssize_t r = ::recv(fd, buf, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    buf += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// recv_all with a deadline: a peer that is alive but wedged (stopped,
// GIL-stuck) never closes its socket, so a bare recv() would block every
// other rank forever.  Steady state gets the same bounded-wait discipline as
// the ht_create accept/dial path.
bool recv_all_timeout(int fd, uint8_t* buf, size_t n, int timeout_ms) {
  while (n > 0) {
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, timeout_ms);
    if (pr < 0 && errno == EINTR) continue;
    if (pr <= 0) return false;  // timeout or poll error
    ssize_t r = ::recv(fd, buf, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR || errno == EAGAIN)) continue;
      return false;
    }
    buf += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

extern "C" {

// Create the full mesh.  hosts: comma-separated peer IPs (n_ranks entries).
// Returns an opaque handle (heap pointer) or nullptr on failure.
void* ht_create(int my_rank, int n_ranks, const char* hosts_csv, int base_port) {
  auto* m = new Mesh();
  m->my_rank = my_rank;
  m->n_ranks = n_ranks;
  m->fds.assign(n_ranks, -1);

  std::vector<std::string> hosts;
  {
    std::string s(hosts_csv ? hosts_csv : "");
    size_t pos = 0;
    while (pos <= s.size()) {
      size_t c = s.find(',', pos);
      if (c == std::string::npos) c = s.size();
      hosts.push_back(s.substr(pos, c - pos));
      pos = c + 1;
    }
  }
  if (static_cast<int>(hosts.size()) < n_ranks) {
    delete m;
    return nullptr;
  }

  // Listen for lower ranks (they dial us).
  m->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(m->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(base_port + my_rank));
  if (bind(m->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(m->listen_fd, n_ranks) != 0) {
    ::close(m->listen_fd);
    delete m;
    return nullptr;
  }

  // Dial higher ranks; accept lower ranks.  Each accepted/established
  // connection starts with a 4-byte rank handshake.
  std::thread acceptor([m]() {
    int need = m->my_rank;  // ranks 0..my_rank-1 dial us
    for (int i = 0; i < need; ++i) {
      // Bounded wait (matches the ~60s dial retry budget): if a lower rank
      // never shows up, ht_create must FAIL, not hang forever in accept().
      pollfd pfd{m->listen_fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, 60 * 1000);
      if (pr <= 0) return;
      int fd = ::accept(m->listen_fd, nullptr, nullptr);
      if (fd < 0) return;
      int32_t peer = -1;
      if (!recv_all(fd, reinterpret_cast<uint8_t*>(&peer), 4) || peer < 0 ||
          peer >= m->n_ranks) {
        ::close(fd);
        return;
      }
      set_common_opts(fd);
      m->fds[peer] = fd;
    }
  });

  bool ok = true;
  for (int peer = m->my_rank + 1; peer < n_ranks; ++peer) {
    int fd = -1;
    for (int attempt = 0; attempt < 600; ++attempt) {  // ~60s of retries
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in pa{};
      pa.sin_family = AF_INET;
      pa.sin_port = htons(static_cast<uint16_t>(base_port + peer));
      inet_pton(AF_INET, hosts[peer].c_str(), &pa.sin_addr);
      if (connect(fd, reinterpret_cast<sockaddr*>(&pa), sizeof(pa)) == 0) break;
      ::close(fd);
      fd = -1;
      usleep(100 * 1000);
    }
    if (fd < 0) {
      ok = false;
      break;
    }
    int32_t me = m->my_rank;
    if (!send_all(fd, reinterpret_cast<const uint8_t*>(&me), 4)) {
      ok = false;
      ::close(fd);
      break;
    }
    set_common_opts(fd);
    m->fds[peer] = fd;
  }

  acceptor.join();
  for (int r = 0; r < n_ranks && ok; ++r) {
    if (r != m->my_rank && m->fds[r] < 0) ok = false;
  }
  if (!ok) {
    for (int fd : m->fds)
      if (fd >= 0) ::close(fd);
    if (m->listen_fd >= 0) ::close(m->listen_fd);
    delete m;
    return nullptr;
  }
  return m;
}

// Exchange fixed-size blocks with every peer.
//   out: n_ranks * block_size bytes; slice r goes to rank r.
//   in:  n_ranks * block_size bytes; slice r receives from rank r.
// The self slice is copied locally.  Returns 0 on success.
int ht_exchange(void* handle, const uint8_t* out, uint64_t block_size, uint8_t* in) {
  auto* m = static_cast<Mesh*>(handle);
  std::vector<std::thread> senders;
  senders.reserve(m->n_ranks);
  std::atomic<bool> send_ok{true};
  for (int r = 0; r < m->n_ranks; ++r) {
    if (r == m->my_rank) {
      std::memcpy(in + r * block_size, out + r * block_size, block_size);
      continue;
    }
    senders.emplace_back([m, r, out, block_size, &send_ok]() {
      if (!send_all(m->fds[r], out + r * block_size, block_size))
        send_ok.store(false, std::memory_order_relaxed);
    });
  }
  bool recv_ok = true;
  for (int r = 0; r < m->n_ranks; ++r) {
    if (r == m->my_rank) continue;
    if (!recv_all_timeout(m->fds[r], in + r * block_size, block_size, 60 * 1000))
      recv_ok = false;
  }
  for (auto& t : senders) t.join();
  return (send_ok.load(std::memory_order_relaxed) && recv_ok) ? 0 : -1;
}

void ht_destroy(void* handle) {
  auto* m = static_cast<Mesh*>(handle);
  if (!m) return;
  for (int fd : m->fds)
    if (fd >= 0) ::close(fd);
  if (m->listen_fd >= 0) ::close(m->listen_fd);
  delete m;
}

}  // extern "C"
