// Native ONNX checkpoint parser for piper-tpu.
//
// The hot loop of model load is the protobuf walk over ~2755 nodes and ~401
// initializers in a ~60-100 MB file (the reference does this in Swift —
// ONNXLoader.swift:23-385 over Wire.swift:42-152). This C++ parser walks the
// wire format once and emits a JSON *index*: graph structure plus byte
// offsets/lengths of every initializer's raw payload, so Python can map
// weights zero-copy with numpy.frombuffer on the original buffer.
//
// C ABI:
//   char* piper_onnx_parse_index(const uint8_t* data, size_t len);
//     -> malloc'd JSON string ("{\"error\": ...}" on failure)
//   void piper_onnx_free(char* p);
//
// Only the subset Piper exports is understood; initializers that don't use
// raw_data are reported with offset -1 and the Python side falls back to its
// own decoder for those tensors.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t pos = 0, end = 0;
  bool ok = true;

  Reader(const uint8_t* data, size_t offset, size_t limit)
      : p(data), pos(offset), end(limit) {}

  bool atEnd() const { return pos >= end || !ok; }

  uint64_t varint() {
    uint64_t r = 0;
    int shift = 0;
    while (true) {
      if (pos >= end || shift > 63) { ok = false; return 0; }
      uint8_t b = p[pos++];
      r |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return r;
      shift += 7;
    }
  }

  // returns (field, wiretype)
  void tag(uint32_t* field, uint32_t* wt) {
    uint64_t t = varint();
    *field = (uint32_t)(t >> 3);
    *wt = (uint32_t)(t & 7);
  }

  void skip(uint32_t wt) {
    switch (wt) {
      case 0: varint(); break;
      case 1: pos += 8; break;
      case 2: { uint64_t n = varint(); pos += n; break; }
      case 5: pos += 4; break;
      default: ok = false;
    }
    if (pos > end) ok = false;
  }

  // length-delimited: returns (offset, length) and advances
  void bytesSpan(size_t* off, size_t* len) {
    uint64_t n = varint();
    if (pos + n > end) { ok = false; *off = 0; *len = 0; return; }
    *off = pos;
    *len = (size_t)n;
    pos += n;
  }

  std::string str() {
    size_t off, len;
    bytesSpan(&off, &len);
    return ok ? std::string((const char*)p + off, len) : std::string();
  }
};

void jsonEscape(const std::string& s, std::string* out) {
  out->push_back('"');
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
  out->push_back('"');
}

int64_t toSigned(uint64_t v) { return (int64_t)v; }

void appendInt(std::string* out, long long v) {
  char buf[32];
  snprintf(buf, sizeof buf, "%lld", v);
  *out += buf;
}

void appendFloat(std::string* out, double v) {
  char buf[64];
  snprintf(buf, sizeof buf, "%.9g", v);
  // JSON requires finite numbers; protobuf floats can be inf/nan in theory.
  if (strstr(buf, "inf") || strstr(buf, "nan")) {
    *out += "null";
  } else {
    *out += buf;
  }
}

// TensorProto: emit {"name":..,"data_type":N,"dims":[..],"offset":N,
// "nbytes":N, ...}. Besides raw_data, real torch exports store payloads in
// the packed repeated fields: float_data/double_data are contiguous
// little-endian scalars (zero-copy viewable — reported as spans), while
// int32_data/int64_data are varint-packed (decoded here into JSON arrays;
// they are small metadata tensors like `sid`).
void parseTensor(Reader r, std::string* out) {
  std::string name;
  long long dataType = 0;
  std::vector<long long> dims;
  long long rawOff = -1, rawLen = 0;
  long long floatOff = -1, floatLen = 0;
  long long doubleOff = -1, doubleLen = 0;
  std::vector<long long> i32data, i64data;
  std::vector<double> inlineFloats;  // rare unpacked float_data entries
  while (!r.atEnd()) {
    uint32_t f, wt;
    r.tag(&f, &wt);
    if (!r.ok) break;
    if (f == 1) {  // dims
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        Reader sub(r.p, off, off + len);
        while (!sub.atEnd()) dims.push_back(toSigned(sub.varint()));
      } else if (wt == 0) {
        dims.push_back(toSigned(r.varint()));
      } else r.skip(wt);
    } else if (f == 2 && wt == 0) {
      dataType = toSigned(r.varint());
    } else if (f == 4) {  // float_data
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        floatOff = (long long)off;
        floatLen = (long long)len;
      } else if (wt == 5) {
        if (r.pos + 4 > r.end) { r.ok = false; break; }
        float v;
        memcpy(&v, r.p + r.pos, 4);
        r.pos += 4;
        inlineFloats.push_back(v);
      } else r.skip(wt);
    } else if (f == 5) {  // int32_data (signed varints)
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        Reader sub(r.p, off, off + len);
        while (!sub.atEnd()) i32data.push_back(toSigned(sub.varint()));
      } else if (wt == 0) {
        i32data.push_back(toSigned(r.varint()));
      } else r.skip(wt);
    } else if (f == 7) {  // int64_data
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        Reader sub(r.p, off, off + len);
        while (!sub.atEnd()) i64data.push_back(toSigned(sub.varint()));
      } else if (wt == 0) {
        i64data.push_back(toSigned(r.varint()));
      } else r.skip(wt);
    } else if (f == 8 && wt == 2) {
      name = r.str();
    } else if (f == 9 && wt == 2) {
      size_t off, len;
      r.bytesSpan(&off, &len);
      rawOff = (long long)off;
      rawLen = (long long)len;
    } else if (f == 10) {  // double_data
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        doubleOff = (long long)off;
        doubleLen = (long long)len;
      } else r.skip(wt);
    } else {
      r.skip(wt);
    }
  }
  *out += "{\"name\":";
  jsonEscape(name, out);
  *out += ",\"data_type\":";
  appendInt(out, dataType);
  *out += ",\"dims\":[";
  for (size_t i = 0; i < dims.size(); i++) {
    if (i) out->push_back(',');
    appendInt(out, dims[i]);
  }
  *out += "],\"offset\":";
  appendInt(out, rawOff);
  *out += ",\"nbytes\":";
  appendInt(out, rawLen);
  if (floatOff >= 0) {
    *out += ",\"float_off\":";
    appendInt(out, floatOff);
    *out += ",\"float_nbytes\":";
    appendInt(out, floatLen);
  }
  if (doubleOff >= 0) {
    *out += ",\"double_off\":";
    appendInt(out, doubleOff);
    *out += ",\"double_nbytes\":";
    appendInt(out, doubleLen);
  }
  if (!inlineFloats.empty()) {
    *out += ",\"float_data\":[";
    for (size_t i = 0; i < inlineFloats.size(); i++) {
      if (i) out->push_back(',');
      appendFloat(out, inlineFloats[i]);
    }
    *out += "]";
  }
  if (!i32data.empty()) {
    *out += ",\"int32_data\":[";
    for (size_t i = 0; i < i32data.size(); i++) {
      if (i) out->push_back(',');
      appendInt(out, i32data[i]);
    }
    *out += "]";
  }
  if (!i64data.empty()) {
    *out += ",\"int64_data\":[";
    for (size_t i = 0; i < i64data.size(); i++) {
      if (i) out->push_back(',');
      appendInt(out, i64data[i]);
    }
    *out += "]";
  }
  *out += "}";
}

// AttributeProto -> "name": {"type":N, "i":.., "f":.., "s":.., "ints":[..], "floats":[..]}
void parseAttribute(Reader r, std::string* out) {
  std::string name, sval;
  bool hasS = false;
  long long ival = 0;
  bool hasI = false;
  double fval = 0;
  bool hasF = false;
  long long declared = 0;
  std::vector<long long> ints;
  std::vector<double> floats;
  std::string tensorJson;  // TENSOR attr (Constant-node weights)
  while (!r.atEnd()) {
    uint32_t f, wt;
    r.tag(&f, &wt);
    if (!r.ok) break;
    if (f == 1 && wt == 2) name = r.str();
    else if (f == 5 && wt == 2) {  // t: TensorProto
      size_t off, len;
      r.bytesSpan(&off, &len);
      parseTensor(Reader(r.p, off, off + len), &tensorJson);
    }
    else if (f == 2 && wt == 5) {
      if (r.pos + 4 > r.end) break;
      float v;
      memcpy(&v, r.p + r.pos, 4);
      r.pos += 4;
      fval = v;
      hasF = true;
    } else if (f == 3 && wt == 0) {
      ival = toSigned(r.varint());
      hasI = true;
    } else if (f == 4 && wt == 2) {
      sval = r.str();
      hasS = true;
    } else if (f == 7) {  // floats
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        for (size_t i = 0; i + 4 <= len; i += 4) {
          float v;
          memcpy(&v, r.p + off + i, 4);
          floats.push_back(v);
        }
      } else if (wt == 5) {
        if (r.pos + 4 > r.end) break;
        float v;
        memcpy(&v, r.p + r.pos, 4);
        r.pos += 4;
        floats.push_back(v);
      } else r.skip(wt);
    } else if (f == 8) {  // ints
      if (wt == 2) {
        size_t off, len;
        r.bytesSpan(&off, &len);
        Reader sub(r.p, off, off + len);
        while (!sub.atEnd()) ints.push_back(toSigned(sub.varint()));
      } else if (wt == 0) {
        ints.push_back(toSigned(r.varint()));
      } else r.skip(wt);
    } else if (f == 20 && wt == 0) {
      declared = toSigned(r.varint());
    } else {
      r.skip(wt);
    }
  }
  jsonEscape(name, out);
  *out += ":{\"type\":";
  appendInt(out, declared);
  if (hasI) { *out += ",\"i\":"; appendInt(out, ival); }
  if (hasF) { *out += ",\"f\":"; appendFloat(out, fval); }
  if (hasS) { *out += ",\"s\":"; jsonEscape(sval, out); }
  if (!ints.empty()) {
    *out += ",\"ints\":[";
    for (size_t i = 0; i < ints.size(); i++) {
      if (i) out->push_back(',');
      appendInt(out, ints[i]);
    }
    *out += "]";
  }
  if (!floats.empty()) {
    *out += ",\"floats\":[";
    for (size_t i = 0; i < floats.size(); i++) {
      if (i) out->push_back(',');
      appendFloat(out, floats[i]);
    }
    *out += "]";
  }
  if (!tensorJson.empty()) {
    *out += ",\"t\":" + tensorJson;
  }
  *out += "}";
}

void parseNode(Reader r, std::string* out) {
  std::string opType, name;
  std::vector<std::string> inputs, outputs;
  std::string attrs;  // accumulated "k":{..} pairs
  bool firstAttr = true;
  while (!r.atEnd()) {
    uint32_t f, wt;
    r.tag(&f, &wt);
    if (!r.ok) break;
    if (f == 1 && wt == 2) inputs.push_back(r.str());
    else if (f == 2 && wt == 2) outputs.push_back(r.str());
    else if (f == 3 && wt == 2) name = r.str();
    else if (f == 4 && wt == 2) opType = r.str();
    else if (f == 5 && wt == 2) {
      size_t off, len;
      r.bytesSpan(&off, &len);
      if (!firstAttr) attrs += ",";
      firstAttr = false;
      parseAttribute(Reader(r.p, off, off + len), &attrs);
    } else {
      r.skip(wt);
    }
  }
  *out += "{\"op_type\":";
  jsonEscape(opType, out);
  *out += ",\"name\":";
  jsonEscape(name, out);
  *out += ",\"inputs\":[";
  for (size_t i = 0; i < inputs.size(); i++) {
    if (i) out->push_back(',');
    jsonEscape(inputs[i], out);
  }
  *out += "],\"outputs\":[";
  for (size_t i = 0; i < outputs.size(); i++) {
    if (i) out->push_back(',');
    jsonEscape(outputs[i], out);
  }
  *out += "],\"attributes\":{" + attrs + "}}";
}

// ValueInfoProto -> {"name":..,"elem_type":N,"shape":[int|string|null,..]}
void parseValueInfo(Reader r, std::string* out) {
  std::string name;
  long long elemType = 0;
  std::string shapeJson;
  bool haveShape = false;
  while (!r.atEnd()) {
    uint32_t f, wt;
    r.tag(&f, &wt);
    if (!r.ok) break;
    if (f == 1 && wt == 2) name = r.str();
    else if (f == 2 && wt == 2) {  // TypeProto
      size_t off, len;
      r.bytesSpan(&off, &len);
      Reader ty(r.p, off, off + len);
      while (!ty.atEnd()) {
        uint32_t f2, w2;
        ty.tag(&f2, &w2);
        if (!ty.ok) break;
        if (f2 == 1 && w2 == 2) {  // tensor_type
          size_t o2, l2;
          ty.bytesSpan(&o2, &l2);
          Reader tt(ty.p, o2, o2 + l2);
          while (!tt.atEnd()) {
            uint32_t f3, w3;
            tt.tag(&f3, &w3);
            if (!tt.ok) break;
            if (f3 == 1 && w3 == 0) elemType = toSigned(tt.varint());
            else if (f3 == 2 && w3 == 2) {  // shape
              haveShape = true;
              size_t o3, l3;
              tt.bytesSpan(&o3, &l3);
              Reader ts(tt.p, o3, o3 + l3);
              bool first = true;
              while (!ts.atEnd()) {
                uint32_t f4, w4;
                ts.tag(&f4, &w4);
                if (!ts.ok) break;
                if (f4 == 1 && w4 == 2) {  // dim
                  size_t o4, l4;
                  ts.bytesSpan(&o4, &l4);
                  Reader dim(ts.p, o4, o4 + l4);
                  if (!first) shapeJson += ",";
                  first = false;
                  std::string dimJson = "null";
                  while (!dim.atEnd()) {
                    uint32_t f5, w5;
                    dim.tag(&f5, &w5);
                    if (!dim.ok) break;
                    if (f5 == 1 && w5 == 0) {
                      dimJson.clear();
                      appendInt(&dimJson, toSigned(dim.varint()));
                    } else if (f5 == 2 && w5 == 2) {
                      dimJson.clear();
                      jsonEscape(dim.str(), &dimJson);
                    } else dim.skip(w5);
                  }
                  shapeJson += dimJson;
                } else ts.skip(w4);
              }
            } else tt.skip(w3);
          }
        } else ty.skip(w2);
      }
    } else {
      r.skip(wt);
    }
  }
  *out += "{\"name\":";
  jsonEscape(name, out);
  *out += ",\"elem_type\":";
  appendInt(out, elemType);
  if (haveShape) {
    *out += ",\"shape\":[" + shapeJson + "]";
  } else {
    *out += ",\"shape\":null";
  }
  *out += "}";
}

}  // namespace

extern "C" {

char* piper_onnx_parse_index(const uint8_t* data, size_t len) {
  std::string out;
  out.reserve(1 << 20);
  Reader r(data, 0, len);
  long long irVersion = 0, opset = 0;
  std::string producer;
  std::string graphJson;
  bool haveGraph = false;

  while (!r.atEnd()) {
    uint32_t f, wt;
    r.tag(&f, &wt);
    if (!r.ok) break;
    if (f == 1 && wt == 0) irVersion = toSigned(r.varint());
    else if (f == 2 && wt == 2) producer = r.str();
    else if (f == 7 && wt == 2) {
      size_t off, glen;
      r.bytesSpan(&off, &glen);
      Reader g(r.p, off, off + glen);
      std::string name;
      std::string nodes = "[", inits = "[", inputs = "[", outputs = "[";
      bool fn = true, fi = true, fin = true, fout = true;
      while (!g.atEnd()) {
        uint32_t f2, w2;
        g.tag(&f2, &w2);
        if (!g.ok) break;
        size_t o2, l2;
        switch (f2) {
          case 1:  // node
            if (w2 != 2) { g.skip(w2); break; }
            g.bytesSpan(&o2, &l2);
            if (!fn) nodes += ",";
            fn = false;
            parseNode(Reader(g.p, o2, o2 + l2), &nodes);
            break;
          case 2:
            if (w2 != 2) { g.skip(w2); break; }
            name = g.str();
            break;
          case 5:  // initializer
            if (w2 != 2) { g.skip(w2); break; }
            g.bytesSpan(&o2, &l2);
            if (!fi) inits += ",";
            fi = false;
            parseTensor(Reader(g.p, o2, o2 + l2), &inits);
            break;
          case 11:  // input
            if (w2 != 2) { g.skip(w2); break; }
            g.bytesSpan(&o2, &l2);
            if (!fin) inputs += ",";
            fin = false;
            parseValueInfo(Reader(g.p, o2, o2 + l2), &inputs);
            break;
          case 12:  // output
            if (w2 != 2) { g.skip(w2); break; }
            g.bytesSpan(&o2, &l2);
            if (!fout) outputs += ",";
            fout = false;
            parseValueInfo(Reader(g.p, o2, o2 + l2), &outputs);
            break;
          default:
            g.skip(w2);
        }
      }
      if (!g.ok) {
        haveGraph = false;
        r.ok = false;
        break;
      }
      graphJson = "{\"name\":";
      jsonEscape(name, &graphJson);
      graphJson += ",\"nodes\":" + nodes + "],\"initializers\":" + inits +
                   "],\"inputs\":" + inputs + "],\"outputs\":" + outputs + "]}";
      haveGraph = true;
    } else if (f == 8 && wt == 2) {  // opset_import
      size_t off, olen;
      r.bytesSpan(&off, &olen);
      Reader osi(r.p, off, off + olen);
      std::string domain;
      long long version = 0;
      while (!osi.atEnd()) {
        uint32_t f2, w2;
        osi.tag(&f2, &w2);
        if (!osi.ok) break;
        if (f2 == 1 && w2 == 2) domain = osi.str();
        else if (f2 == 2 && w2 == 0) version = toSigned(osi.varint());
        else osi.skip(w2);
      }
      if (domain.empty() || domain == "ai.onnx") opset = version;
    } else {
      r.skip(wt);
    }
  }

  if (!r.ok || !haveGraph) {
    out = "{\"error\":\"malformed or unsupported ONNX protobuf\"}";
  } else {
    out = "{\"ir_version\":";
    appendInt(&out, irVersion);
    out += ",\"opset_version\":";
    appendInt(&out, opset);
    out += ",\"producer_name\":";
    jsonEscape(producer, &out);
    out += ",\"graph\":" + graphJson + "}";
  }
  char* res = (char*)malloc(out.size() + 1);
  memcpy(res, out.c_str(), out.size() + 1);
  return res;
}

void piper_onnx_free(char* p) { free(p); }

}  // extern "C"
