// Native runtime components for rtc_tpu.
//
// The reference implements its entire runtime in native code (Rust); here the
// device compute path is XLA/Pallas and the HOST runtime pieces that sit on the
// critical path are C++: OBJ ingestion (reference: src/obj_file.rs), PPM
// encoding (reference: src/canvas.rs:28-63), and Morton-cluster construction
// for the mesh acceleration structure. Exposed through a minimal C ABI and
// bound via ctypes (rtc_tpu/native.py) with pure-Python fallbacks.
//
// Build: make -C native   (-> librtc_native.so)

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing (reference: src/obj_file.rs:29-113)
//
// Supports the reference's subset: `v x y z`, `f i j k [l ...]` (fan
// triangulation, plain 1-based indices only), `g name`, everything else
// counted as ignored. Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------

struct ObjResult {
  std::vector<double> vertices;   // xyz triples
  std::vector<int64_t> faces;     // vertex-index triples (0-based)
  std::vector<int64_t> face_group; // group id per face (-1 = default group)
  std::vector<std::string> group_names;
  int64_t ignored_lines = 0;
};

static thread_local std::string g_error;

void* obj_parse(const char* text, int64_t len) {
  auto* res = new ObjResult();
  const char* p = text;
  const char* end = text + len;
  int64_t current_group = -1;

  auto skip_ws = [&](const char*& q, const char* line_end) {
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
  };

  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = p;
    skip_ws(q, line_end);
    if (q >= line_end) { p = line_end + 1; continue; }  // blank: not counted

    if (*q == 'v' && (q + 1 < line_end) && (q[1] == ' ' || q[1] == '\t')) {
      q++;
      double xyz[3];
      bool ok = true;
      for (int i = 0; i < 3; i++) {
        skip_ws(q, line_end);
        char* num_end = nullptr;
        xyz[i] = strtod(q, &num_end);
        if (num_end == q || num_end > line_end) { ok = false; break; }
        q = num_end;
      }
      if (!ok) { g_error = "bad vertex line"; delete res; return nullptr; }
      res->vertices.insert(res->vertices.end(), xyz, xyz + 3);
    } else if (*q == 'f' && (q + 1 < line_end) && (q[1] == ' ' || q[1] == '\t')) {
      q++;
      std::vector<int64_t> idx;
      while (true) {
        skip_ws(q, line_end);
        if (q >= line_end) break;
        char* num_end = nullptr;
        long long v = strtoll(q, &num_end, 10);
        if (num_end == q) break;
        // the reference's usize parse panics on 1/2/3 forms (src/obj_file.rs:58-76)
        if (num_end < line_end && *num_end == '/') {
          g_error = "slash-form face indices unsupported";
          delete res;
          return nullptr;
        }
        idx.push_back(static_cast<int64_t>(v) - 1);
        q = num_end;
      }
      if (idx.size() < 3) { g_error = "face needs >= 3 vertices"; delete res; return nullptr; }
      for (size_t i = 1; i + 1 < idx.size(); i++) {  // fan triangulation
        res->faces.push_back(idx[0]);
        res->faces.push_back(idx[i]);
        res->faces.push_back(idx[i + 1]);
        res->face_group.push_back(current_group);
      }
    } else if (*q == 'g' && (q + 1 < line_end) && (q[1] == ' ' || q[1] == '\t')) {
      q++;
      skip_ws(q, line_end);
      const char* name_start = q;
      while (q < line_end && !isspace(static_cast<unsigned char>(*q))) q++;
      std::string name(name_start, q - name_start);
      if (name.empty()) { g_error = "group needs a name"; delete res; return nullptr; }
      // repeated name resets the group, like HashMap::insert (src/obj_file.rs:101-103)
      int64_t gid = -1;
      for (size_t i = 0; i < res->group_names.size(); i++)
        if (res->group_names[i] == name) { gid = static_cast<int64_t>(i); break; }
      if (gid < 0) {
        gid = static_cast<int64_t>(res->group_names.size());
        res->group_names.push_back(name);
      } else {
        // drop previously collected faces of this group
        for (size_t i = 0; i < res->face_group.size();) {
          if (res->face_group[i] == gid) {
            res->faces.erase(res->faces.begin() + 3 * i, res->faces.begin() + 3 * i + 3);
            res->face_group.erase(res->face_group.begin() + i);
          } else {
            i++;
          }
        }
      }
      current_group = gid;
    } else {
      res->ignored_lines++;  // (src/obj_file.rs:107)
    }
    p = line_end + 1;
  }
  return res;
}

const char* obj_last_error() { return g_error.c_str(); }

int64_t obj_num_vertices(void* h) { return static_cast<ObjResult*>(h)->vertices.size() / 3; }
int64_t obj_num_faces(void* h) { return static_cast<ObjResult*>(h)->faces.size() / 3; }
int64_t obj_num_groups(void* h) { return static_cast<ObjResult*>(h)->group_names.size(); }
int64_t obj_ignored_lines(void* h) { return static_cast<ObjResult*>(h)->ignored_lines; }

void obj_copy_vertices(void* h, double* out) {
  auto* r = static_cast<ObjResult*>(h);
  memcpy(out, r->vertices.data(), r->vertices.size() * sizeof(double));
}
void obj_copy_faces(void* h, int64_t* out) {
  auto* r = static_cast<ObjResult*>(h);
  memcpy(out, r->faces.data(), r->faces.size() * sizeof(int64_t));
}
void obj_copy_face_groups(void* h, int64_t* out) {
  auto* r = static_cast<ObjResult*>(h);
  memcpy(out, r->face_group.data(), r->face_group.size() * sizeof(int64_t));
}
int64_t obj_group_name(void* h, int64_t i, char* out, int64_t cap) {
  auto* r = static_cast<ObjResult*>(h);
  const std::string& s = r->group_names[static_cast<size_t>(i)];
  int64_t n = std::min<int64_t>(cap - 1, static_cast<int64_t>(s.size()));
  memcpy(out, s.data(), n);
  out[n] = 0;
  return static_cast<int64_t>(s.size());
}
void obj_free(void* h) { delete static_cast<ObjResult*>(h); }

// ---------------------------------------------------------------------------
// PPM encoding (reference: src/canvas.rs:28-63)
//
// P3 header, clamp [0,1] -> round-half-away 0..255, 70-char line wrapping,
// per-row newline, trailing newline. ~100x faster than the Python loop at
// 1080p.
// ---------------------------------------------------------------------------

int64_t ppm_encode(const double* pixels, int64_t width, int64_t height,
                   char* out, int64_t cap) {
  // Returns bytes written (excluding NUL), or required size if out == null.
  std::string buf;
  buf.reserve(static_cast<size_t>(width * height * 12 + 64));
  char tmp[32];
  snprintf(tmp, sizeof tmp, "P3\n%lld %lld\n255\n",
           static_cast<long long>(width), static_cast<long long>(height));
  buf += tmp;
  for (int64_t y = 0; y < height; y++) {
    int line_len = 0;
    for (int64_t i = 0; i < width * 3; i++) {
      double v = pixels[(y * width * 3) + i];
      v = v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v);
      int iv = static_cast<int>(std::floor(v * 255.0 + 0.5));
      int n = snprintf(tmp, sizeof tmp, "%d", iv);
      if (line_len + n + 1 > 70) {
        buf += '\n';
        line_len = 0;
      }
      if (line_len > 0) {
        buf += ' ';
        line_len += 1;
      }
      buf.append(tmp, n);
      line_len += n;
    }
    buf += '\n';
  }
  if (out && cap >= static_cast<int64_t>(buf.size())) {
    memcpy(out, buf.data(), buf.size());
  }
  return static_cast<int64_t>(buf.size());
}

// ---------------------------------------------------------------------------
// Morton-cluster construction (host side of the Pallas mesh accelerator)
// ---------------------------------------------------------------------------

static inline uint64_t spread10(uint64_t v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

void morton_order(const double* centroids, int64_t n, int64_t* order_out) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; i++)
    for (int c = 0; c < 3; c++) {
      double v = centroids[i * 3 + c];
      lo[c] = std::min(lo[c], v);
      hi[c] = std::max(hi[c], v);
    }
  double ext[3];
  for (int c = 0; c < 3; c++) ext[c] = (hi[c] - lo[c]) > 0 ? hi[c] - lo[c] : 1.0;

  std::vector<std::pair<uint64_t, int64_t>> keyed(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++) {
    uint64_t code = 0;
    for (int c = 0; c < 3; c++) {
      double q = (centroids[i * 3 + c] - lo[c]) / ext[c] * 1023.0;
      q = q < 0 ? 0 : (q > 1023 ? 1023 : q);
      code |= spread10(static_cast<uint64_t>(q)) << c;
    }
    keyed[static_cast<size_t>(i)] = {code, i};
  }
  std::stable_sort(keyed.begin(), keyed.end());
  for (int64_t i = 0; i < n; i++) order_out[i] = keyed[static_cast<size_t>(i)].second;
}

}  // extern "C"
