// Shared-memory object store: arena allocator + object table + LRU eviction.
//
// TPU-native equivalent of the reference's plasma store
// (src/ray/object_manager/plasma/: store.h:55, object_lifecycle_manager.h:106,
// eviction_policy.h:160, plasma_allocator.h). Design difference from plasma:
// instead of a standalone store process that passes fds over a unix socket
// (fling.cc), the store is a library embedded in the per-node raylet process.
// The arena is a file in /dev/shm; clients simply mmap the same path read-only
// and receive (offset, size) ranges over RPC — same zero-copy property,
// drastically less machinery.
//
// Concurrency: the embedding process serializes calls (Python side holds a
// lock); no internal locking needed beyond what the single writer provides.
//
// Build: g++ -O2 -shared -fPIC -o libshm_store.so shm_store.cc

#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>
#include <cstdint>
#include <cstring>
#include <list>
#include <map>
#include <set>
#include <string>
#include <unordered_map>

namespace {

constexpr uint64_t kAlignment = 64;

inline uint64_t AlignUp(uint64_t n) { return (n + kAlignment - 1) & ~(kAlignment - 1); }

enum class ObjectState : uint8_t { kCreated = 0, kSealed = 1 };

struct Entry {
  uint64_t offset = 0;
  uint64_t data_size = 0;
  uint64_t meta_size = 0;
  uint64_t alloc_size = 0;
  int64_t ref_count = 0;
  ObjectState state = ObjectState::kCreated;
  // Pinned objects (primary copies, reference
  // local_object_manager.h:110 PinObjectsAndWaitForFree) are never
  // LRU-evicted; the embedding raylet must spill them to disk first.
  bool pinned = false;
  // Position in the LRU list when evictable (sealed && ref_count == 0 &&
  // !pinned).
  bool in_lru = false;
  std::list<std::string>::iterator lru_it;
};

// Best-fit free-list allocator with coalescing over [0, capacity).
// Plays the role of plasma's dlmalloc arena (plasma_allocator.h, dlmalloc.cc).
class Arena {
 public:
  explicit Arena(uint64_t capacity) : capacity_(capacity) {
    free_by_offset_[0] = capacity;
    InsertBySize(0, capacity);
  }

  bool Allocate(uint64_t size, uint64_t* offset_out) {
    size = AlignUp(size == 0 ? kAlignment : size);
    // Best fit: smallest free block >= size.
    auto it = free_by_size_.lower_bound({size, 0});
    if (it == free_by_size_.end()) return false;
    uint64_t block_size = it->first;
    uint64_t offset = it->second;
    free_by_size_.erase(it);
    free_by_offset_.erase(offset);
    if (block_size > size) {
      free_by_offset_[offset + size] = block_size - size;
      InsertBySize(offset + size, block_size - size);
    }
    used_ += size;
    *offset_out = offset;
    return true;
  }

  void Free(uint64_t offset, uint64_t size) {
    size = AlignUp(size == 0 ? kAlignment : size);
    used_ -= size;
    // Coalesce with successor.
    auto next = free_by_offset_.lower_bound(offset);
    if (next != free_by_offset_.end() && next->first == offset + size) {
      size += next->second;
      EraseBySize(next->first, next->second);
      free_by_offset_.erase(next);
    }
    // Coalesce with predecessor.
    auto prev = free_by_offset_.lower_bound(offset);
    if (prev != free_by_offset_.begin()) {
      --prev;
      if (prev->first + prev->second == offset) {
        offset = prev->first;
        size += prev->second;
        EraseBySize(prev->first, prev->second);
        free_by_offset_.erase(prev);
      }
    }
    free_by_offset_[offset] = size;
    InsertBySize(offset, size);
  }

  uint64_t used() const { return used_; }
  uint64_t capacity() const { return capacity_; }

 private:
  void InsertBySize(uint64_t offset, uint64_t size) {
    free_by_size_.insert({size, offset});
  }
  void EraseBySize(uint64_t offset, uint64_t size) {
    free_by_size_.erase({size, offset});
  }

  uint64_t capacity_;
  uint64_t used_ = 0;
  std::map<uint64_t, uint64_t> free_by_offset_;          // offset -> size
  std::set<std::pair<uint64_t, uint64_t>> free_by_size_;  // (size, offset)
};

class Store {
 public:
  Store(void* base, uint64_t capacity, int fd, bool owns_file, std::string path)
      : base_(static_cast<uint8_t*>(base)),
        arena_(capacity),
        fd_(fd),
        owns_file_(owns_file),
        path_(std::move(path)) {}

  ~Store() {
    munmap(base_, arena_.capacity());
    close(fd_);
    if (owns_file_) unlink(path_.c_str());
  }

  // rc: 0 ok, -1 already exists, -2 out of memory.
  int CreateObject(const std::string& id, uint64_t data_size, uint64_t meta_size,
                   uint64_t* offset_out) {
    if (table_.count(id)) return -1;
    uint64_t total = data_size + meta_size;
    uint64_t offset;
    if (!arena_.Allocate(total, &offset)) {
      // LRU-evict sealed unreferenced objects then retry
      // (eviction_policy.h:160 LRUCache::ChooseObjectsToEvict).
      EvictUntil(AlignUp(total));
      if (!arena_.Allocate(total, &offset)) return -2;
    }
    Entry e;
    e.offset = offset;
    e.data_size = data_size;
    e.meta_size = meta_size;
    e.alloc_size = total;
    e.state = ObjectState::kCreated;
    e.ref_count = 1;  // creator holds a ref until seal+release
    table_[id] = e;
    *offset_out = offset;
    return 0;
  }

  int Seal(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    if (it->second.state == ObjectState::kSealed) return -3;
    it->second.state = ObjectState::kSealed;
    num_sealed_++;
    return 0;
  }

  // rc: 0 ok, -1 missing, -2 not yet sealed.
  int Get(const std::string& id, uint64_t* offset, uint64_t* data_size,
          uint64_t* meta_size) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    if (it->second.state != ObjectState::kSealed) return -2;
    Touch(id, it->second);
    *offset = it->second.offset;
    *data_size = it->second.data_size;
    *meta_size = it->second.meta_size;
    return 0;
  }

  int AddRef(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    it->second.ref_count++;
    RemoveFromLru(id, it->second);
    return 0;
  }

  int Release(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    if (--it->second.ref_count <= 0) {
      it->second.ref_count = 0;
      if (it->second.state == ObjectState::kSealed) AddToLru(id, it->second);
    }
    return 0;
  }

  // rc: 0 ok, -1 missing, -2 still referenced.
  int Delete(const std::string& id, bool force) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    if (it->second.ref_count > 0 && !force) return -2;
    RemoveFromLru(id, it->second);
    if (it->second.state == ObjectState::kSealed) num_sealed_--;
    arena_.Free(it->second.offset, it->second.alloc_size);
    table_.erase(it);
    return 0;
  }

  int Contains(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return 0;
    return it->second.state == ObjectState::kSealed ? 2 : 1;
  }

  int Pin(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    it->second.pinned = true;
    RemoveFromLru(id, it->second);
    return 0;
  }

  int Unpin(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    it->second.pinned = false;
    if (it->second.state == ObjectState::kSealed && it->second.ref_count <= 0)
      AddToLru(id, it->second);
    return 0;
  }

  int64_t RefCount(const std::string& id) {
    auto it = table_.find(id);
    if (it == table_.end()) return -1;
    return it->second.ref_count;
  }

  uint64_t EvictUntil(uint64_t bytes_needed) {
    uint64_t freed = 0;
    while (freed < bytes_needed && !lru_.empty()) {
      std::string victim = lru_.front();  // front = least recently used
      auto it = table_.find(victim);
      if (it == table_.end()) {
        lru_.pop_front();
        continue;
      }
      freed += it->second.alloc_size;
      Delete(victim, /*force=*/false);
    }
    return freed;
  }

  uint64_t used() const { return arena_.used(); }
  uint64_t capacity() const { return arena_.capacity(); }
  uint64_t num_objects() const { return table_.size(); }
  uint64_t num_sealed() const { return num_sealed_; }
  uint8_t* base() const { return base_; }

 private:
  void Touch(const std::string& id, Entry& e) {
    if (e.in_lru) {
      lru_.erase(e.lru_it);
      e.lru_it = lru_.insert(lru_.end(), id);
    }
  }
  void AddToLru(const std::string& id, Entry& e) {
    if (e.pinned) return;
    if (!e.in_lru) {
      e.lru_it = lru_.insert(lru_.end(), id);
      e.in_lru = true;
    }
  }
  void RemoveFromLru(const std::string& id, Entry& e) {
    if (e.in_lru) {
      lru_.erase(e.lru_it);
      e.in_lru = false;
    }
  }

  uint8_t* base_;
  Arena arena_;
  int fd_;
  bool owns_file_;
  std::string path_;
  uint64_t num_sealed_ = 0;
  std::unordered_map<std::string, Entry> table_;
  std::list<std::string> lru_;
};

}  // namespace

extern "C" {

void* store_create(const char* path, uint64_t capacity) {
  int fd = open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  return new Store(base, capacity, fd, /*owns_file=*/true, path);
}

void store_destroy(void* s) { delete static_cast<Store*>(s); }

int store_create_object(void* s, const uint8_t* id, uint32_t id_len,
                        uint64_t data_size, uint64_t meta_size,
                        uint64_t* offset_out) {
  return static_cast<Store*>(s)->CreateObject(
      std::string(reinterpret_cast<const char*>(id), id_len), data_size,
      meta_size, offset_out);
}

int store_seal(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->Seal(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int store_get(void* s, const uint8_t* id, uint32_t id_len, uint64_t* offset,
              uint64_t* data_size, uint64_t* meta_size) {
  return static_cast<Store*>(s)->Get(
      std::string(reinterpret_cast<const char*>(id), id_len), offset, data_size,
      meta_size);
}

int store_add_ref(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->AddRef(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int store_release(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->Release(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int store_delete(void* s, const uint8_t* id, uint32_t id_len, int force) {
  return static_cast<Store*>(s)->Delete(
      std::string(reinterpret_cast<const char*>(id), id_len), force != 0);
}

int store_contains(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->Contains(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int store_pin(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->Pin(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int store_unpin(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->Unpin(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

int64_t store_ref_count(void* s, const uint8_t* id, uint32_t id_len) {
  return static_cast<Store*>(s)->RefCount(
      std::string(reinterpret_cast<const char*>(id), id_len));
}

uint64_t store_evict(void* s, uint64_t nbytes) {
  return static_cast<Store*>(s)->EvictUntil(nbytes);
}

uint64_t store_used(void* s) { return static_cast<Store*>(s)->used(); }
uint64_t store_capacity(void* s) { return static_cast<Store*>(s)->capacity(); }
uint64_t store_num_objects(void* s) { return static_cast<Store*>(s)->num_objects(); }
uint8_t* store_base(void* s) { return static_cast<Store*>(s)->base(); }

}  // extern "C"
