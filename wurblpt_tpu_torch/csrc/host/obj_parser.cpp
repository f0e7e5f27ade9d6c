// Fast OBJ/MTL parser for scene import.
//
// Native host-side equivalent of the reference's vendored tiny_obj_loader
// (used by libwurblpt/import.hpp:211-215): parses v/vn/vt/f records with
// polygon-fan triangulation and negative-index resolution, tracks usemtl per
// face, and loads the referenced MTL libraries (newmtl, Ka/Kd/Ks/Ke, Ns, Ni,
// d/Tr, illum, map_* incl. bump options). Exposed through a handle-based
// C ABI consumed via ctypes (wurblpt_tpu/io/obj.py); material records are
// serialized as JSON to keep the ABI to plain buffers.
//
// Built with -fno-exceptions: all parsing uses strtof/strtol, failures return
// null/-1 instead of throwing.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct MtlTexture {
    std::string name;       // path as written in the MTL
    float bump_multiplier = 1.0f;
};

struct Mtl {
    std::string name;
    float ka[3] = {0, 0, 0};
    float kd[3] = {0.8f, 0.8f, 0.8f};
    float ks[3] = {0, 0, 0};
    float ke[3] = {0, 0, 0};
    float tr[3] = {0, 0, 0};    // transmittance (Tf)
    float ns = 0.0f;            // shininess
    float ni = 1.0f;            // index of refraction
    float d = 1.0f;             // opacity (dissolve)
    int illum = 2;
    MtlTexture map_kd, map_ks, map_ke, map_d, map_ns, map_bump, map_norm;
};

struct ObjData {
    std::vector<float> v, vn, vt;
    // Per triangle corner: vertex/normal/texcoord indices (-1 = absent).
    std::vector<int> fv, fn, ft;
    std::vector<int> fmat;      // per triangle material id (-1 = none)
    std::vector<Mtl> materials;
    std::string error;
};

inline const char* skip_ws(const char* p) {
    while (*p == ' ' || *p == '\t' || *p == '\r') p++;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

inline float parse_float(const char*& p) {
    char* q;
    float f = strtof(p, &q);
    p = q;
    return f;
}

inline std::string parse_name(const char* p, const char* line_end) {
    p = skip_ws(p);
    const char* e = line_end;
    while (e > p && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) e--;
    return std::string(p, e - p);
}

// Parse a texture statement: skip -options, return path + bump multiplier.
MtlTexture parse_texture(const char* p, const char* line_end) {
    MtlTexture t;
    p = skip_ws(p);
    while (p < line_end && *p == '-') {
        // known options: -bm f | -o x y z | -s x y z | -t x y z | -mm a b |
        // -blendu/-blendv/-clamp on/off | -imfchan c | -type t
        const char* opt = p;
        while (p < line_end && *p != ' ' && *p != '\t') p++;
        size_t olen = p - opt;
        int nargs = 1;
        if ((olen == 2 && !strncmp(opt, "-o", 2)) ||
            (olen == 2 && !strncmp(opt, "-s", 2)) ||
            (olen == 2 && !strncmp(opt, "-t", 2)))
            nargs = 3;
        else if (olen == 3 && !strncmp(opt, "-mm", 3))
            nargs = 2;
        if (olen == 3 && !strncmp(opt, "-bm", 3)) {
            p = skip_ws(p);
            t.bump_multiplier = parse_float(p);
        } else {
            for (int i = 0; i < nargs; i++) {
                p = skip_ws(p);
                while (p < line_end && *p != ' ' && *p != '\t') p++;
            }
        }
        p = skip_ws(p);
    }
    t.name = parse_name(p, line_end);
    return t;
}

void parse_mtl(const std::string& path, std::vector<Mtl>& out) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf(sz, '\0');
    if (fread(&buf[0], 1, sz, f) != (size_t)sz) { fclose(f); return; }
    fclose(f);

    const char* p = buf.data();
    const char* end = p + buf.size();
    Mtl* cur = nullptr;
    while (p < end) {
        const char* le = p;
        while (le < end && *le != '\n') le++;
        p = skip_ws(p);
        auto starts = [&](const char* kw) {
            size_t l = strlen(kw);
            return (size_t)(le - p) > l && !strncmp(p, kw, l) &&
                   (p[l] == ' ' || p[l] == '\t');
        };
        if (starts("newmtl")) {
            out.push_back(Mtl());
            cur = &out.back();
            cur->name = parse_name(p + 6, le);
        } else if (cur) {
            if (starts("Ka")) { const char* q = p + 2; for (int i = 0; i < 3; i++) cur->ka[i] = parse_float(q); }
            else if (starts("Kd")) { const char* q = p + 2; for (int i = 0; i < 3; i++) cur->kd[i] = parse_float(q); }
            else if (starts("Ks")) { const char* q = p + 2; for (int i = 0; i < 3; i++) cur->ks[i] = parse_float(q); }
            else if (starts("Ke")) { const char* q = p + 2; for (int i = 0; i < 3; i++) cur->ke[i] = parse_float(q); }
            else if (starts("Tf")) { const char* q = p + 2; for (int i = 0; i < 3; i++) cur->tr[i] = parse_float(q); }
            else if (starts("Ns")) { const char* q = p + 2; cur->ns = parse_float(q); }
            else if (starts("Ni")) { const char* q = p + 2; cur->ni = parse_float(q); }
            else if (starts("d"))  { const char* q = p + 1; cur->d = parse_float(q); }
            else if (starts("Tr")) { const char* q = p + 2; cur->d = 1.0f - parse_float(q); }
            else if (starts("illum")) { const char* q = p + 5; cur->illum = (int)strtol(q, nullptr, 10); }
            else if (starts("map_Kd")) cur->map_kd = parse_texture(p + 6, le);
            else if (starts("map_Ks")) cur->map_ks = parse_texture(p + 6, le);
            else if (starts("map_Ke")) cur->map_ke = parse_texture(p + 6, le);
            else if (starts("map_d"))  cur->map_d = parse_texture(p + 5, le);
            else if (starts("map_Ns")) cur->map_ns = parse_texture(p + 6, le);
            else if (starts("map_bump") || starts("map_Bump")) cur->map_bump = parse_texture(p + 8, le);
            else if (starts("bump")) cur->map_bump = parse_texture(p + 4, le);
            else if (starts("norm")) cur->map_norm = parse_texture(p + 4, le);
        }
        p = le < end ? le + 1 : end;
    }
}

inline int resolve_index(long idx, size_t count) {
    // OBJ: 1-based; negative = relative to current end.
    if (idx > 0) return (int)(idx - 1);
    if (idx < 0) return (int)(count + idx);
    return -1;
}

ObjData* parse_obj(const char* path, const char* mtl_dir) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf(sz, '\0');
    if (fread(&buf[0], 1, sz, f) != (size_t)sz) { fclose(f); return nullptr; }
    fclose(f);

    ObjData* od = new ObjData();
    int cur_mat = -1;
    std::vector<int> corner_v, corner_n, corner_t;  // polygon scratch

    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* le = p;
        while (le < end && *le != '\n') le++;
        p = skip_ws(p);
        if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            const char* q = p + 1;
            for (int i = 0; i < 3; i++) od->v.push_back(parse_float(q));
        } else if (p[0] == 'v' && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) {
            const char* q = p + 2;
            for (int i = 0; i < 3; i++) od->vn.push_back(parse_float(q));
        } else if (p[0] == 'v' && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) {
            const char* q = p + 2;
            for (int i = 0; i < 2; i++) od->vt.push_back(parse_float(q));
        } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            corner_v.clear(); corner_n.clear(); corner_t.clear();
            const char* q = p + 1;
            while (q < le) {
                q = skip_ws(q);
                if (q >= le || *q == '\n') break;
                char* qe;
                long vi = strtol(q, &qe, 10);
                if (qe == q) break;
                q = qe;
                long ti = 0, ni = 0;
                if (*q == '/') {
                    q++;
                    if (*q != '/') { ti = strtol(q, &qe, 10); q = qe; }
                    if (*q == '/') { q++; ni = strtol(q, &qe, 10); q = qe; }
                }
                corner_v.push_back(resolve_index(vi, od->v.size() / 3));
                corner_t.push_back(ti ? resolve_index(ti, od->vt.size() / 2) : -1);
                corner_n.push_back(ni ? resolve_index(ni, od->vn.size() / 3) : -1);
            }
            // Fan triangulation (tinyobj triangulate=true equivalent).
            for (size_t i = 2; i < corner_v.size(); i++) {
                od->fv.push_back(corner_v[0]); od->fv.push_back(corner_v[i - 1]); od->fv.push_back(corner_v[i]);
                od->fn.push_back(corner_n[0]); od->fn.push_back(corner_n[i - 1]); od->fn.push_back(corner_n[i]);
                od->ft.push_back(corner_t[0]); od->ft.push_back(corner_t[i - 1]); od->ft.push_back(corner_t[i]);
                od->fmat.push_back(cur_mat);
            }
        } else if (!strncmp(p, "usemtl", 6)) {
            std::string name = parse_name(p + 6, le);
            cur_mat = -1;
            for (size_t i = 0; i < od->materials.size(); i++)
                if (od->materials[i].name == name) { cur_mat = (int)i; break; }
        } else if (!strncmp(p, "mtllib", 6)) {
            std::string name = parse_name(p + 6, le);
            std::string full = mtl_dir && mtl_dir[0]
                ? std::string(mtl_dir) + "/" + name : name;
            parse_mtl(full, od->materials);
        }
        p = le < end ? le + 1 : end;
    }
    return od;
}

void json_escape(const std::string& s, std::string& out) {
    for (char c : s) {
        if (c == '"' || c == '\\') { out += '\\'; out += c; }
        else if ((unsigned char)c >= 0x20) out += c;
    }
}

void json_tex(const char* key, const MtlTexture& t, std::string& out) {
    char tmp[64];
    out += "\""; out += key; out += "\":{\"name\":\"";
    json_escape(t.name, out);
    snprintf(tmp, sizeof tmp, "\",\"bm\":%g},", t.bump_multiplier);
    out += tmp;
}

}  // namespace

extern "C" {

void* wobj_parse(const char* path, const char* mtl_dir) {
    return parse_obj(path, mtl_dir);
}

void wobj_counts(void* h, long long* counts) {
    ObjData* od = (ObjData*)h;
    counts[0] = od->v.size() / 3;
    counts[1] = od->vn.size() / 3;
    counts[2] = od->vt.size() / 2;
    counts[3] = od->fv.size() / 3;
    counts[4] = od->materials.size();
}

void wobj_vertices(void* h, float* v, float* vn, float* vt) {
    ObjData* od = (ObjData*)h;
    memcpy(v, od->v.data(), od->v.size() * sizeof(float));
    if (!od->vn.empty()) memcpy(vn, od->vn.data(), od->vn.size() * sizeof(float));
    if (!od->vt.empty()) memcpy(vt, od->vt.data(), od->vt.size() * sizeof(float));
}

void wobj_faces(void* h, int* fv, int* fn, int* ft, int* fmat) {
    ObjData* od = (ObjData*)h;
    memcpy(fv, od->fv.data(), od->fv.size() * sizeof(int));
    memcpy(fn, od->fn.data(), od->fn.size() * sizeof(int));
    memcpy(ft, od->ft.data(), od->ft.size() * sizeof(int));
    memcpy(fmat, od->fmat.data(), od->fmat.size() * sizeof(int));
}

int wobj_material_json(void* h, int mi, char* buf, int cap) {
    ObjData* od = (ObjData*)h;
    if (mi < 0 || mi >= (int)od->materials.size()) return -1;
    const Mtl& m = od->materials[mi];
    std::string out = "{\"name\":\"";
    json_escape(m.name, out);
    out += "\",";
    char tmp[256];
    snprintf(tmp, sizeof tmp,
             "\"kd\":[%g,%g,%g],\"ks\":[%g,%g,%g],\"ke\":[%g,%g,%g],"
             "\"tr\":[%g,%g,%g],\"ns\":%g,\"ni\":%g,\"d\":%g,\"illum\":%d,",
             m.kd[0], m.kd[1], m.kd[2], m.ks[0], m.ks[1], m.ks[2],
             m.ke[0], m.ke[1], m.ke[2], m.tr[0], m.tr[1], m.tr[2],
             m.ns, m.ni, m.d, m.illum);
    out += tmp;
    json_tex("map_kd", m.map_kd, out);
    json_tex("map_ks", m.map_ks, out);
    json_tex("map_ke", m.map_ke, out);
    json_tex("map_d", m.map_d, out);
    json_tex("map_ns", m.map_ns, out);
    json_tex("map_bump", m.map_bump, out);
    json_tex("map_norm", m.map_norm, out);
    out.back() = '}';  // replace trailing comma
    if ((int)out.size() + 1 > cap) return (int)out.size() + 1;
    memcpy(buf, out.c_str(), out.size() + 1);
    return (int)out.size();
}

void wobj_free(void* h) {
    delete (ObjData*)h;
}

}  // extern "C"
