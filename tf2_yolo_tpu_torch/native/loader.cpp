// Native data loader of tf2_yolo_tpu_torch (a copy of the JAX package's
// tf2_yolo_tpu/native/loader.cpp, the same C ABI).
//
// The reference's only host-side parallelism is Python threads around
// PIL/BeautifulSoup (reference utils/tools.py:323-334): the GIL and
// per-call Python overhead make the input pipeline the training
// bottleneck. This library moves the whole hot path native: JPEG/PNG
// decode, bilinear resize to the network input size, labelimg-XML
// parsing, and anchor-grid label encoding, fanned out over a std::thread
// pool. Exposed as a C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: tf2_yolo_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// -std=c++17 loader.cpp -ljpeg -lpng, into build/native/ at the root of
// the checkout).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------
// image decoding
// ---------------------------------------------------------------------

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, RGB
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(static_cast<size_t>(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* buf;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
  }
  memcpy(out, s->buf + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{buf, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize everything to 8-bit RGB
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = static_cast<int>(w);
  out->h = static_cast<int>(h);
  out->c = 3;
  out->data.resize(static_cast<size_t>(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) {
    rows[y] = out->data.data() + static_cast<size_t>(y) * w * 3;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(len));
  size_t got = fread(out->data(), 1, static_cast<size_t>(len), f);
  fclose(f);
  return got == static_cast<size_t>(len);
}

bool decode_image(const uint8_t* buf, size_t len, Image* out) {
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
    return decode_jpeg(buf, len, out);
  }
  if (len >= 8 && !png_sig_cmp(buf, 0, 8)) {
    return decode_png(buf, len, out);
  }
  // fall back to trying both
  return decode_jpeg(buf, len, out) || decode_png(buf, len, out);
}

// bilinear resize HWC uint8 RGB
void resize_bilinear(const Image& src, int out_h, int out_w,
                     uint8_t* out) {
  const float sx = static_cast<float>(src.w) / out_w;
  const float sy = static_cast<float>(src.h) / out_h;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 < 0) y1 = 0;
    if (y0 >= src.h) y0 = src.h - 1;
    if (y1 >= src.h) y1 = src.h - 1;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(floorf(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 < 0) x1 = 0;
      if (x0 >= src.w) x0 = src.w - 1;
      if (x1 >= src.w) x1 = src.w - 1;
      const uint8_t* p00 = &src.data[(static_cast<size_t>(y0) * src.w + x0) * 3];
      const uint8_t* p01 = &src.data[(static_cast<size_t>(y0) * src.w + x1) * 3];
      const uint8_t* p10 = &src.data[(static_cast<size_t>(y1) * src.w + x0) * 3];
      const uint8_t* p11 = &src.data[(static_cast<size_t>(y1) * src.w + x1) * 3];
      uint8_t* dst = out + (static_cast<size_t>(oy) * out_w + ox) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                  wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
        dst[ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// ---------------------------------------------------------------------
// labelimg XML parsing (minimal, schema-specific)
// ---------------------------------------------------------------------

std::string find_tag(const std::string& s, const std::string& tag,
                     size_t from, size_t* end_out) {
  const std::string open = "<" + tag + ">";
  const std::string close = "</" + tag + ">";
  size_t a = s.find(open, from);
  if (a == std::string::npos) return "";
  a += open.size();
  size_t b = s.find(close, a);
  if (b == std::string::npos) return "";
  if (end_out) *end_out = b + close.size();
  std::string val = s.substr(a, b - a);
  // trim
  size_t l = val.find_first_not_of(" \t\r\n");
  size_t r = val.find_last_not_of(" \t\r\n");
  if (l == std::string::npos) return "";
  return val.substr(l, r - l + 1);
}

}  // namespace

extern "C" {

// Decode + resize one image. out must hold out_h*out_w*3 bytes.
// zoom_wh[2] receives (orig_w/out_w, orig_h/out_h). Returns 0 on ok.
int yolo_load_image(const char* path, int out_h, int out_w,
                    uint8_t* out, double* zoom_wh) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  Image img;
  if (!decode_image(buf.data(), buf.size(), &img)) return 2;
  resize_bilinear(img, out_h, out_w, out);
  if (zoom_wh) {
    zoom_wh[0] = static_cast<double>(img.w) / out_w;
    zoom_wh[1] = static_cast<double>(img.h) / out_h;
  }
  return 0;
}

// Batched threaded image load. paths: n C strings. out: n*out_h*out_w*3.
// zooms: n*2. Returns number of failed images.
int yolo_load_batch(const char** paths, int n, int out_h, int out_w,
                    uint8_t* out, double* zooms, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> fails(n_threads, 0);
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      int rc = yolo_load_image(paths[i], out_h, out_w,
                               out + img_bytes * i,
                               zooms ? zooms + 2 * i : nullptr);
      if (rc != 0) fails[tid]++;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& t : pool) t.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

// Parse labelimg XML text. class_names: '\n'-separated name list.
// boxes: max_boxes*4 doubles (xmin,ymin,xmax,ymax); labels: max_boxes
// ints. Returns the number of boxes written (objects whose name is
// not in class_names are skipped, like reference tools.py:246).
int yolo_parse_labelimg(const char* xml_text, const char* class_names,
                        int max_boxes, double* boxes, int* labels) {
  std::string xml(xml_text);
  std::vector<std::string> names;
  {
    std::string all(class_names);
    size_t pos = 0;
    while (pos <= all.size()) {
      size_t nl = all.find('\n', pos);
      if (nl == std::string::npos) nl = all.size();
      names.push_back(all.substr(pos, nl - pos));
      pos = nl + 1;
    }
  }

  int count = 0;
  size_t cursor = 0;
  while (count < max_boxes) {
    size_t obj_at = xml.find("<object>", cursor);
    if (obj_at == std::string::npos) break;
    size_t obj_end = xml.find("</object>", obj_at);
    if (obj_end == std::string::npos) break;
    std::string obj = xml.substr(obj_at, obj_end - obj_at);
    cursor = obj_end + 9;

    std::string name = find_tag(obj, "name", 0, nullptr);
    int label = -1;
    for (size_t k = 0; k < names.size(); ++k) {
      if (names[k] == name) {
        label = static_cast<int>(k);
        break;
      }
    }
    if (label < 0) continue;

    std::string xmin = find_tag(obj, "xmin", 0, nullptr);
    std::string ymin = find_tag(obj, "ymin", 0, nullptr);
    std::string xmax = find_tag(obj, "xmax", 0, nullptr);
    std::string ymax = find_tag(obj, "ymax", 0, nullptr);
    if (xmin.empty() || ymin.empty() || xmax.empty() || ymax.empty()) {
      continue;
    }
    boxes[count * 4 + 0] = atoi(xmin.c_str());
    boxes[count * 4 + 1] = atoi(ymin.c_str());
    boxes[count * 4 + 2] = atoi(xmax.c_str());
    boxes[count * 4 + 3] = atoi(ymax.c_str());
    labels[count] = label;
    ++count;
  }
  return count;
}

// Encode pixel-space xyxy boxes into a grid label, matching the
// reference codec quirks (utils/tools.py:179-209): floor cell index,
// last-write xywh, accumulating class bits, out-of-range drop with
// negative wrap-around.
void yolo_encode_grid(const double* boxes, const int* labels, int n,
                      int img_h, int img_w, int grid_h, int grid_w,
                      int class_num, float* out /* gh*gw*(5+C) */) {
  const int ch = 5 + class_num;
  const double cell_w = static_cast<double>(img_w) / grid_w;
  const double cell_h = static_cast<double>(img_h) / grid_h;
  for (int i = 0; i < n; ++i) {
    double x1 = boxes[i * 4 + 0], y1 = boxes[i * 4 + 1];
    double x2 = boxes[i * 4 + 2], y2 = boxes[i * 4 + 3];
    double cx = x1 + (x2 - x1) / 2, cy = y1 + (y2 - y1) / 2;
    double bw = x2 - x1, bh = y2 - y1;
    int xi = static_cast<int>(floor(cx / cell_w));
    int yi = static_cast<int>(floor(cy / cell_h));
    if (xi >= grid_w || yi >= grid_h) continue;
    // negative indices wrap like NumPy indexing in the reference
    if (xi < 0) xi += grid_w;
    if (yi < 0) yi += grid_h;
    if (xi < 0 || yi < 0) continue;
    float* cellp = out + (static_cast<size_t>(yi) * grid_w + xi) * ch;
    double mx = fmod(cx, cell_w);
    double my = fmod(cy, cell_h);
    if (mx < 0) mx += cell_w;
    if (my < 0) my += cell_h;
    cellp[0] = static_cast<float>(mx / cell_w);
    cellp[1] = static_cast<float>(my / cell_h);
    cellp[2] = static_cast<float>(bw / img_w);
    cellp[3] = static_cast<float>(bh / img_h);
    cellp[4] = 1.0f;
    cellp[5 + labels[i]] = 1.0f;
  }
}

// Full-batch pipeline: images + XMLs -> resized images + grid labels.
// img_out: n*out_h*out_w*3 uint8; label_out: n*grid_h*grid_w*(5+C)
// f32 (zero-initialized by caller). xml_paths entries may be NULL to
// skip labels. Returns number of failures.
int yolo_load_and_encode_batch(
    const char** img_paths, const char** xml_paths, int n,
    int out_h, int out_w, int grid_h, int grid_w,
    const char* class_names, int class_num, int max_boxes,
    uint8_t* img_out, float* label_out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> fails(n_threads, 0);
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  const size_t lab_elems =
      static_cast<size_t>(grid_h) * grid_w * (5 + class_num);

  auto work = [&](int tid) {
    std::vector<double> boxes(static_cast<size_t>(max_boxes) * 4);
    std::vector<int> labels(max_boxes);
    for (int i = tid; i < n; i += n_threads) {
      double zoom[2] = {1.0, 1.0};
      if (yolo_load_image(img_paths[i], out_h, out_w,
                          img_out + img_bytes * i, zoom) != 0) {
        fails[tid]++;
        continue;
      }
      if (!xml_paths || !xml_paths[i]) continue;
      std::vector<uint8_t> xml;
      if (!read_file(xml_paths[i], &xml)) {
        fails[tid]++;
        continue;
      }
      xml.push_back(0);
      int nb = yolo_parse_labelimg(
          reinterpret_cast<const char*>(xml.data()), class_names,
          max_boxes, boxes.data(), labels.data());
      // rescale from original pixels to resized pixels
      for (int b = 0; b < nb; ++b) {
        boxes[b * 4 + 0] /= zoom[0];
        boxes[b * 4 + 1] /= zoom[1];
        boxes[b * 4 + 2] /= zoom[0];
        boxes[b * 4 + 3] /= zoom[1];
      }
      yolo_encode_grid(boxes.data(), labels.data(), nb, out_h, out_w,
                       grid_h, grid_w, class_num,
                       label_out + lab_elems * i);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& t : pool) t.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // extern "C"
