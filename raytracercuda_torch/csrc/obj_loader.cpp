// Native OBJ tokenizer of the PyTorch port: the port's own copy of the JAX
// package's `native/obj_loader.cpp` (the same grammar and C ABI), so the port
// never builds or loads a file of the JAX package's tree.
//
// Role parity: the reference's model import is native code (Assimp behind
// TestProgram/Model.cpp).  This is a single-pass OBJ tokenizer exposed
// through a C ABI consumed via ctypes.  The Python parser in
// `models/loader.py` implements the same grammar; the tests compare the two.
//
// Grammar: v / vn / vt / f (v, v/t, v//n, v/t/n, negative indices, n-gon
// fan triangulation), usemtl, mtllib.  Outputs raw arrays; vertex
// unification and material resolution stay in Python (numpy handles them
// well).
//
// Build: `native/native_loader.py` runs g++ -O2 -std=c++17 -fPIC -shared at
// first use, into the git-ignored `raytracercuda_torch/_build/`.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> v;        // positions, 3 per vertex
  std::vector<float> vn;       // normals, 3 per
  std::vector<float> vt;       // uvs, 2 per
  std::vector<int64_t> corners;  // triangulated: 9 per face (3 corners x (v,t,n)); -1 = absent
  std::vector<int32_t> face_mat;  // per triangle: material index into mat_names
  std::string mat_names;       // '\n'-joined usemtl names, in first-use order
  std::string mtl_files;       // '\n'-joined mtllib names
  std::vector<std::string> mat_list;
};

// Fast float parse (strtof on a bounded token).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_token(const char* p, const char* end, const char** tok_end) {
  p = skip_ws(p, end);
  const char* q = p;
  while (q < end && *q != ' ' && *q != '\t' && *q != '\r' && *q != '\n') ++q;
  *tok_end = q;
  return p;
}

int32_t material_index(ObjData* d, const std::string& name) {
  for (size_t i = 0; i < d->mat_list.size(); ++i)
    if (d->mat_list[i] == name) return (int32_t)i;
  // Separator keyed on list size, not blob emptiness: the default ""
  // material at index 0 must still occupy a (possibly empty) slot.
  if (!d->mat_list.empty()) d->mat_names += '\n';
  d->mat_list.push_back(name);
  d->mat_names += name;
  return (int32_t)d->mat_list.size() - 1;
}

// Parse an OBJ face corner "v[/vt][/vn]" with 1-based or negative indices.
void parse_corner(const char* tok, const char* end, int64_t nv, int64_t nt,
                  int64_t nn, int64_t out[3]) {
  int64_t vals[3] = {0, 0, 0};
  bool present[3] = {false, false, false};
  int comp = 0;
  const char* p = tok;
  while (p < end && comp < 3) {
    if (*p == '/') {
      ++comp;
      ++p;
      continue;
    }
    char* q;
    long long x = strtoll(p, &q, 10);
    if (q != p) {
      vals[comp] = x;
      present[comp] = true;
      p = q;
    } else {
      ++p;
    }
  }
  const int64_t counts[3] = {nv, nt, nn};
  for (int i = 0; i < 3; ++i) {
    if (!present[i] || vals[i] == 0)
      out[i] = -1;
    else if (vals[i] > 0)
      out[i] = vals[i] - 1;
    else
      out[i] = counts[i] + vals[i];
  }
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  ObjData* d = new ObjData();
  int32_t cur_mat = material_index(d, "");
  const char* p = buf.data();
  const char* end = p + buf.size();

  std::vector<int64_t> refs;  // corner triples of the current face
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q + 1 < line_end) {
      if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
        char* r = const_cast<char*>(q + 1);
        for (int i = 0; i < 3; ++i) d->v.push_back(strtof(r, &r));
      } else if (q[0] == 'v' && q[1] == 'n') {
        char* r = const_cast<char*>(q + 2);
        for (int i = 0; i < 3; ++i) d->vn.push_back(strtof(r, &r));
      } else if (q[0] == 'v' && q[1] == 't') {
        char* r = const_cast<char*>(q + 2);
        d->vt.push_back(strtof(r, &r));
        d->vt.push_back(strtof(r, &r));
      } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
        refs.clear();
        const char* r = q + 1;
        const int64_t nv = (int64_t)d->v.size() / 3;
        const int64_t nt = (int64_t)d->vt.size() / 2;
        const int64_t nn = (int64_t)d->vn.size() / 3;
        while (r < line_end) {
          const char* tok_end;
          const char* tok = next_token(r, line_end, &tok_end);
          if (tok == tok_end) break;
          int64_t c[3];
          parse_corner(tok, tok_end, nv, nt, nn, c);
          refs.push_back(c[0]);
          refs.push_back(c[1]);
          refs.push_back(c[2]);
          r = tok_end;
        }
        size_t ncorn = refs.size() / 3;
        for (size_t k = 1; k + 1 < ncorn; ++k) {  // fan triangulation
          for (size_t cc : {(size_t)0, k, k + 1}) {
            d->corners.push_back(refs[cc * 3 + 0]);
            d->corners.push_back(refs[cc * 3 + 1]);
            d->corners.push_back(refs[cc * 3 + 2]);
          }
          d->face_mat.push_back(cur_mat);
        }
      } else if (!strncmp(q, "usemtl", 6)) {
        const char* tok_end;
        const char* tok = next_token(q + 6, line_end, &tok_end);
        cur_mat = material_index(d, std::string(tok, tok_end));
      } else if (!strncmp(q, "mtllib", 6)) {
        const char* tok_end;
        const char* tok = next_token(q + 6, line_end, &tok_end);
        if (!d->mtl_files.empty()) d->mtl_files += '\n';
        d->mtl_files.append(tok, tok_end);
      }
    }
    p = line_end + 1;
  }
  return d;
}

void obj_counts(void* h, int64_t* out6) {
  ObjData* d = (ObjData*)h;
  out6[0] = (int64_t)d->v.size() / 3;
  out6[1] = (int64_t)d->vn.size() / 3;
  out6[2] = (int64_t)d->vt.size() / 2;
  out6[3] = (int64_t)d->face_mat.size();  // triangles
  out6[4] = (int64_t)d->mat_names.size();
  out6[5] = (int64_t)d->mtl_files.size();
}

void obj_copy(void* h, float* v, float* vn, float* vt, int64_t* corners,
              int32_t* face_mat, char* mat_names, char* mtl_files) {
  ObjData* d = (ObjData*)h;
  if (v) memcpy(v, d->v.data(), d->v.size() * sizeof(float));
  if (vn) memcpy(vn, d->vn.data(), d->vn.size() * sizeof(float));
  if (vt) memcpy(vt, d->vt.data(), d->vt.size() * sizeof(float));
  if (corners) memcpy(corners, d->corners.data(), d->corners.size() * sizeof(int64_t));
  if (face_mat) memcpy(face_mat, d->face_mat.data(), d->face_mat.size() * sizeof(int32_t));
  if (mat_names) memcpy(mat_names, d->mat_names.data(), d->mat_names.size());
  if (mtl_files) memcpy(mtl_files, d->mtl_files.data(), d->mtl_files.size());
}

void obj_free(void* h) { delete (ObjData*)h; }

}  // extern "C"
