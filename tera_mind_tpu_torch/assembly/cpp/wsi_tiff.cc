// wsi_tiff.cc — streaming tiled pyramidal BigTIFF writer for whole-slide
// images, written against the TIFF 6.0 / BigTIFF specification.
//
// Purpose: TPU-native replacement for the reference pipeline's pyvips-based
// WSI assembly (CTPLab/Tera-MIND infer_brn.py:11-105 writes QuPath-readable
// pyramidal OME-TIFFs).  libvips/libtiff dev headers are not available in
// this image, so the container format is emitted directly:
//
//   - BigTIFF (0x2B) little-endian, 8-byte offsets (73728x106496 px slices
//     exceed classic TIFF's 4 GiB addressing)
//   - one IFD per pyramid level, chained; level 0 full-res, deeper levels
//     flagged NewSubfileType=1 (reduced-resolution), the layout QuPath and
//     bioformats read natively
//   - 256x256 tiles, grayscale 8-bit; compression: raw (=1), zlib/deflate
//     (COMPRESSION_ADOBE_DEFLATE=8), or per-tile JPEG streams
//     (COMPRESSION_JPEG=7, libjpeg; the reference's pyvips default uses
//     jpeg-in-tiff the same way, infer_brn.py:84-88)
//   - OME-XML in ImageDescription of IFD 0
//
// Streaming: tile data is appended as it arrives (any order); IFDs and
// offset tables are written on close.  Memory is O(#tiles) for the offset
// tables only — a full brain slice (~120k tiles incl. pyramid) needs ~2 MB.
//
// Exposed as a C ABI for Python ctypes (no pybind11 in the image).
//
// Build: g++ -O2 -shared -fPIC -o libwsitiff.so wsi_tiff.cc -lz -ljpeg

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <jpeglib.h>
#include <zlib.h>

namespace {

constexpr uint16_t kTagNewSubfileType = 254;
constexpr uint16_t kTagImageWidth = 256;
constexpr uint16_t kTagImageLength = 257;
constexpr uint16_t kTagBitsPerSample = 258;
constexpr uint16_t kTagCompression = 259;
constexpr uint16_t kTagPhotometric = 262;
constexpr uint16_t kTagImageDescription = 270;
constexpr uint16_t kTagSamplesPerPixel = 277;
constexpr uint16_t kTagSoftware = 305;
constexpr uint16_t kTagTileWidth = 322;
constexpr uint16_t kTagTileLength = 323;
constexpr uint16_t kTagTileOffsets = 324;
constexpr uint16_t kTagTileByteCounts = 325;
constexpr uint16_t kTagSampleFormat = 339;

constexpr uint16_t kTypeShort = 3;   // u16
constexpr uint16_t kTypeLong = 4;    // u32
constexpr uint16_t kTypeAscii = 2;
constexpr uint16_t kTypeLong8 = 16;  // u64 (BigTIFF)

struct IfdEntry {
  uint16_t tag;
  uint16_t type;
  uint64_t count;
  uint64_t value;  // inline value or offset
};

struct Level {
  uint64_t width = 0, height = 0;
  uint32_t tiles_x = 0, tiles_y = 0;
  std::vector<uint64_t> offsets;
  std::vector<uint64_t> bytecounts;
};

struct Writer {
  FILE* f = nullptr;
  uint32_t tile = 256;
  int compression = 8;  // 8 = deflate, 1 = none
  int zlevel = 6;
  std::string ome_xml;
  std::vector<Level> levels;
  uint64_t pos = 0;  // current append offset
  bool failed = false;

  void append(const void* data, size_t n) {
    if (failed) return;
    if (fwrite(data, 1, n, f) != n) failed = true;
    pos += n;
  }
  template <typename T>
  void put(T v) {
    append(&v, sizeof(T));
  }
  void pad_to_even() {
    if (pos & 1) put<uint8_t>(0);
  }
};

void write_header(Writer* w) {
  // BigTIFF: "II" 0x2B, bytesize-of-offsets=8, constant 0, first-IFD offset
  // (patched on close).
  w->put<uint16_t>(0x4949);
  w->put<uint16_t>(0x002B);
  w->put<uint16_t>(8);
  w->put<uint16_t>(0);
  w->put<uint64_t>(0);  // first IFD offset placeholder (patched at close)
}

std::vector<uint8_t> deflate_tile(const uint8_t* data, size_t n, int level) {
  uLongf cap = compressBound(n);
  std::vector<uint8_t> out(cap);
  if (compress2(out.data(), &cap, data, n, level) != Z_OK) return {};
  out.resize(cap);
  return out;
}

// One complete grayscale JPEG stream per tile (TIFF compression 7 stores a
// standalone JPEG per tile).
std::vector<uint8_t> jpeg_tile(const uint8_t* data, uint32_t w, uint32_t h,
                               int quality) {
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  unsigned char* mem = nullptr;
  unsigned long sz = 0;
  jpeg_mem_dest(&cinfo, &mem, &sz);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 1;
  cinfo.in_color_space = JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < h) {
    JSAMPROW row = (JSAMPROW)(data + (size_t)cinfo.next_scanline * w);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::vector<uint8_t> out(mem, mem + sz);
  free(mem);
  return out;
}

uint64_t write_ifd(Writer* w, const Level& lv, bool first,
                   const std::string& desc) {
  // out-of-line arrays first
  uint64_t off_offsets = 0, off_counts = 0, off_desc = 0;
  const uint64_t ntiles = lv.offsets.size();
  w->pad_to_even();
  if (ntiles * 8 > 8) {
    off_offsets = w->pos;
    w->append(lv.offsets.data(), ntiles * 8);
    off_counts = w->pos;
    w->append(lv.bytecounts.data(), ntiles * 8);
  }
  if (first && desc.size() > 8) {
    off_desc = w->pos;
    w->append(desc.data(), desc.size() + 1);  // include NUL
  }
  w->pad_to_even();

  std::vector<IfdEntry> e;
  e.push_back({kTagNewSubfileType, kTypeLong, 1, first ? 0ull : 1ull});
  e.push_back({kTagImageWidth, kTypeLong, 1, lv.width});
  e.push_back({kTagImageLength, kTypeLong, 1, lv.height});
  e.push_back({kTagBitsPerSample, kTypeShort, 1, 8});
  e.push_back({kTagCompression, kTypeShort, 1,
               (uint64_t)w->compression});
  e.push_back({kTagPhotometric, kTypeShort, 1, 1});  // min-is-black
  if (first && !desc.empty()) {
    uint64_t cnt = desc.size() + 1;
    e.push_back({kTagImageDescription, kTypeAscii, cnt,
                 cnt <= 8 ? 0 : off_desc});
  }
  e.push_back({kTagSamplesPerPixel, kTypeShort, 1, 1});
  e.push_back({kTagTileWidth, kTypeShort, 1, w->tile});
  e.push_back({kTagTileLength, kTypeShort, 1, w->tile});
  e.push_back({kTagTileOffsets, kTypeLong8, ntiles,
               ntiles == 1 ? lv.offsets[0] : off_offsets});
  e.push_back({kTagTileByteCounts, kTypeLong8, ntiles,
               ntiles == 1 ? lv.bytecounts[0] : off_counts});
  e.push_back({kTagSampleFormat, kTypeShort, 1, 1});

  uint64_t ifd_off = w->pos;
  w->put<uint64_t>((uint64_t)e.size());
  for (const auto& en : e) {
    w->put<uint16_t>(en.tag);
    w->put<uint16_t>(en.type);
    w->put<uint64_t>(en.count);
    w->put<uint64_t>(en.value);
  }
  w->put<uint64_t>(0);  // next-IFD placeholder (patched by caller)
  return ifd_off;
}

}  // namespace

extern "C" {

// Create a writer. levels = number of pyramid levels (>=1). width/height of
// level 0; deeper levels are ceil-halved. compression: 1=none, 8=deflate.
void* wsi_open(const char* path, uint64_t width, uint64_t height,
               uint32_t tile, int levels, int compression, int zlevel,
               const char* ome_xml) {
  FILE* f = fopen(path, "wb+");
  if (!f) return nullptr;
  auto* w = new Writer;
  w->f = f;
  w->tile = tile;
  w->compression = compression;
  w->zlevel = zlevel;
  if (ome_xml) w->ome_xml = ome_xml;
  uint64_t lw = width, lh = height;
  for (int i = 0; i < levels; i++) {
    Level lv;
    lv.width = lw;
    lv.height = lh;
    lv.tiles_x = (uint32_t)((lw + tile - 1) / tile);
    lv.tiles_y = (uint32_t)((lh + tile - 1) / tile);
    lv.offsets.assign((size_t)lv.tiles_x * lv.tiles_y, 0);
    lv.bytecounts.assign((size_t)lv.tiles_x * lv.tiles_y, 0);
    w->levels.push_back(std::move(lv));
    lw = (lw + 1) / 2;
    lh = (lh + 1) / 2;
  }
  write_header(w);
  return w;
}

// Write one tile (tile*tile uint8, row-major). Returns 0 on success.
int wsi_write_tile(void* h, int level, uint32_t tx, uint32_t ty,
                   const uint8_t* data) {
  auto* w = (Writer*)h;
  if (!w || w->failed || level < 0 || level >= (int)w->levels.size())
    return -1;
  Level& lv = w->levels[level];
  if (tx >= lv.tiles_x || ty >= lv.tiles_y) return -2;
  const size_t n = (size_t)w->tile * w->tile;
  const uint8_t* payload = data;
  std::vector<uint8_t> comp;
  size_t nbytes = n;
  if (w->compression == 8) {
    comp = deflate_tile(data, n, w->zlevel);
    if (comp.empty()) return -3;
    payload = comp.data();
    nbytes = comp.size();
  } else if (w->compression == 7) {
    comp = jpeg_tile(data, w->tile, w->tile, w->zlevel);  // zlevel = quality
    if (comp.empty()) return -3;
    payload = comp.data();
    nbytes = comp.size();
  }
  size_t idx = (size_t)ty * lv.tiles_x + tx;
  lv.offsets[idx] = w->pos;
  lv.bytecounts[idx] = nbytes;
  w->append(payload, nbytes);
  return w->failed ? -4 : 0;
}

// Finish: writes IFD chain, patches header. Returns 0 on success.
int wsi_close(void* h) {
  auto* w = (Writer*)h;
  if (!w) return -1;
  // empty tiles (never written): point at a shared blank tile
  {
    const size_t n = (size_t)w->tile * w->tile;
    std::vector<uint8_t> blank(n, 0);
    uint64_t blank_off = 0, blank_len = 0;
    for (auto& lv : w->levels) {
      for (size_t i = 0; i < lv.offsets.size(); i++) {
        if (lv.offsets[i] == 0) {
          if (blank_off == 0) {
            if (w->compression == 8) {
              auto comp = deflate_tile(blank.data(), n, w->zlevel);
              blank_off = w->pos;
              blank_len = comp.size();
              w->append(comp.data(), comp.size());
            } else if (w->compression == 7) {
              auto comp = jpeg_tile(blank.data(), w->tile, w->tile,
                                    w->zlevel);
              blank_off = w->pos;
              blank_len = comp.size();
              w->append(comp.data(), comp.size());
            } else {
              blank_off = w->pos;
              blank_len = n;
              w->append(blank.data(), n);
            }
          }
          lv.offsets[i] = blank_off;
          lv.bytecounts[i] = blank_len;
        }
      }
    }
  }
  // IFD chain
  std::vector<uint64_t> ifd_offsets;
  std::vector<uint64_t> next_fixups;  // file positions of next-IFD fields
  for (size_t i = 0; i < w->levels.size(); i++) {
    uint64_t off = write_ifd(w, w->levels[i], i == 0, w->ome_xml);
    ifd_offsets.push_back(off);
  }
  int rc = w->failed ? -2 : 0;
  // patch header -> first IFD, and each IFD's next pointer
  if (rc == 0) {
    fflush(w->f);
    auto patch = [&](uint64_t at, uint64_t value) {
      if (fseek(w->f, (long)at, SEEK_SET) != 0 ||
          fwrite(&value, 8, 1, w->f) != 1)
        rc = -3;
    };
    patch(8, ifd_offsets[0]);
    for (size_t i = 0; i + 1 < ifd_offsets.size(); i++) {
      // next-IFD field sits after count(8) + entries(20 each)
      uint64_t nentries;
      fseek(w->f, (long)ifd_offsets[i], SEEK_SET);
      if (fread(&nentries, 8, 1, w->f) != 1) { rc = -4; break; }
      patch(ifd_offsets[i] + 8 + nentries * 20, ifd_offsets[i + 1]);
    }
  }
  fclose(w->f);
  delete w;
  return rc;
}

}  // extern "C"
