// Threaded VCF -> GTrack valued-points converter (native data loader).
//
// Mirrors io/vcf.py exactly (which defines the semantics, after
// reference tools/VCFConvert.py:2-86): find the #CHROM header, map the
// requested population names to columns (missing names dropped, order
// preserved), locate GT in the FIRST data line's FORMAT (the reference
// computes it once, VCFConvert.py:31), and emit one
// `chrom\tpos\tcode\tname` row per (SNP, individual) with the code map
// 0/0|0|0 -> 3, 1/1|1|1 -> -3, 0/1,1/0 (either separator) -> 0,
// everything else (./., half-missing, multi-allelic) -> -10000.
//
// Parallelism: the data region is split at line boundaries; each thread
// renders its rows into a private buffer; buffers are written in order
// (same pattern as gtrack_parser.cpp).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Field {
  const char* p;
  size_t len;
};

// split a line into tab-separated fields (string views into the buffer)
void split_tabs(const char* p, const char* end, std::vector<Field>* out) {
  out->clear();
  const char* start = p;
  while (p < end) {
    if (*p == '\t') {
      out->push_back({start, static_cast<size_t>(p - start)});
      start = p + 1;
    }
    ++p;
  }
  out->push_back({start, static_cast<size_t>(end - start)});
}

// index into kCode: 0 -> "3", 1 -> "-3", 2 -> "0", 3 -> "-10000"
int geno_code_idx(const char* gt, size_t len) {
  if (len != 3) return 3;
  char sep = gt[1];
  if (sep != '/' && sep != '|') return 3;
  char a = gt[0], b = gt[2];
  if (a == '0' && b == '0') return 0;
  if (a == '1' && b == '1') return 1;
  if ((a == '0' && b == '1') || (a == '1' && b == '0')) return 2;
  return 3;  // ./., half-missing, multi-allelic, malformed
}

const char* line_end(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
  return nl ? nl : end;
}

struct ConvertSpec {
  int chromidx, posidx, gtidx;
  std::vector<int> popidx;
  std::vector<std::string> names;
};

void convert_chunk(const char* p, const char* end, const ConvertSpec* spec,
                   std::string* out, int* status) {
  std::vector<Field> fields;
  fields.reserve(64);
  // the only four codes, as ready-made strings (snprintf per row cost
  // ~40% of the conversion)
  static const char* kCode[4] = {"3", "-3", "0", "-10000"};
  static const size_t kCodeLen[4] = {1, 2, 1, 6};
  while (p < end) {
    const char* le = line_end(p, end);
    if (le > p && *p != '#') {
      split_tabs(p, le, &fields);
      int maxidx = spec->chromidx > spec->posidx ? spec->chromidx
                                                 : spec->posidx;
      if (static_cast<int>(fields.size()) <= maxidx) {
        // malformed/truncated line: the Python semantics definition
        // raises IndexError here — report instead of fabricating rows
        *status = -7;
        return;
      }
      {
        const Field& chrom = fields[static_cast<size_t>(spec->chromidx)];
        const Field& pos = fields[static_cast<size_t>(spec->posidx)];
        for (size_t i = 0; i < spec->popidx.size(); ++i) {
          int col = spec->popidx[i];
          if (static_cast<int>(fields.size()) <= col) {
            *status = -7;  // sample column missing: Python IndexErrors
            return;
          }
          int ci = 3;  // default missing
          {
            const Field& f = fields[static_cast<size_t>(col)];
            // take sub-field gtidx of the ':'-separated call
            const char* q = f.p;
            const char* qe = f.p + f.len;
            int sub = 0;
            const char* s = q;
            const char* gt = nullptr;
            size_t gtlen = 0;
            while (q <= qe) {
              if (q == qe || *q == ':') {
                if (sub == spec->gtidx) {
                  gt = s;
                  gtlen = static_cast<size_t>(q - s);
                  break;
                }
                ++sub;
                s = q + 1;
              }
              ++q;
            }
            if (!gt) {
              *status = -7;  // GT sub-field missing: Python IndexErrors
              return;
            }
            ci = geno_code_idx(gt, gtlen);
          }
          out->append(chrom.p, chrom.len);
          out->push_back('\t');
          out->append(pos.p, pos.len);
          out->push_back('\t');
          out->append(kCode[ci], kCodeLen[ci]);
          out->push_back('\t');
          out->append(spec->names[i]);
          out->push_back('\n');
        }
      }
    }
    p = le + 1;
  }
}

}  // namespace

extern "C" {

// Returns the number of (SNP, individual) rows written, or negative on
// error (-1 open, -2 read, -3 no #CHROM header, -4 missing POS/FORMAT,
// -5 no GT in FORMAT, -6 output open failed, -7 malformed data line).
// found_buf receives the newline-separated population names actually
// present in the header.
long long vcf_convert(const char* vcf_path, const char* out_path,
                      const char* gtrack_header, const char* names_nlsv,
                      char* found_buf, long long found_cap,
                      int n_threads) {
  FILE* f = fopen(vcf_path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 0) {
    fclose(f);
    return -2;
  }
  std::vector<char> buf(static_cast<size_t>(fsize) + 1, '\0');
  if (fsize > 0 && fread(buf.data(), 1, static_cast<size_t>(fsize), f) !=
                       static_cast<size_t>(fsize)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  const char* base = buf.data();
  const char* end = base + fsize;

  // locate the #CHROM header line
  ConvertSpec spec;
  spec.gtidx = -1;
  const char* p = base;
  const char* data_start = nullptr;
  int formatidx = -1;
  std::vector<Field> fields;
  while (p < end) {
    const char* le = line_end(p, end);
    if (le - p >= 6 && memcmp(p, "#CHROM", 6) == 0) {
      split_tabs(p, le, &fields);
      spec.chromidx = spec.posidx = -1;
      for (size_t i = 0; i < fields.size(); ++i) {
        std::string name(fields[i].p, fields[i].len);
        if (name == "#CHROM") spec.chromidx = static_cast<int>(i);
        if (name == "POS") spec.posidx = static_cast<int>(i);
        if (name == "FORMAT") formatidx = static_cast<int>(i);
      }
      if (spec.chromidx < 0 || spec.posidx < 0 || formatidx < 0) return -4;
      // map population names (preserving request order, dropping
      // missing); '\n'-separated — a newline cannot occur inside a VCF
      // header column, unlike ',' which is legal in sample IDs
      std::string csv(names_nlsv);
      size_t start = 0;
      while (start <= csv.size()) {
        size_t comma = csv.find('\n', start);
        if (comma == std::string::npos) comma = csv.size();
        std::string want = csv.substr(start, comma - start);
        if (!want.empty()) {
          for (size_t i = 0; i < fields.size(); ++i) {
            if (want.size() == fields[i].len &&
                memcmp(want.data(), fields[i].p, want.size()) == 0) {
              spec.popidx.push_back(static_cast<int>(i));
              spec.names.push_back(want);
              break;
            }
          }
        }
        start = comma + 1;
      }
      data_start = le + 1;
      break;
    }
    p = le + 1;
  }
  if (!data_start) return -3;

  // GT index from the first data line's FORMAT (computed once, like the
  // reference and io/vcf.py)
  p = data_start;
  while (p < end) {
    const char* le = line_end(p, end);
    if (le > p && *p != '#') {
      split_tabs(p, le, &fields);
      if (static_cast<int>(fields.size()) > formatidx) {
        const Field& fmt = fields[static_cast<size_t>(formatidx)];
        const char* q = fmt.p;
        const char* qe = fmt.p + fmt.len;
        const char* s = q;
        int sub = 0;
        while (q <= qe) {
          if (q == qe || *q == ':') {
            if (q - s == 2 && s[0] == 'G' && s[1] == 'T') {
              spec.gtidx = sub;
              break;
            }
            ++sub;
            s = q + 1;
          }
          ++q;
        }
      }
      break;
    }
    p = le + 1;
  }
  if (spec.gtidx < 0) return -5;

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (end - data_start < (1 << 20)) n_threads = 1;

  // chunk boundaries snapped to line starts
  std::vector<const char*> starts(static_cast<size_t>(n_threads) + 1);
  size_t nbytes = static_cast<size_t>(end - data_start);
  starts[0] = data_start;
  for (int t = 1; t < n_threads; ++t) {
    const char* guess =
        data_start + nbytes * static_cast<size_t>(t) /
                         static_cast<size_t>(n_threads);
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', static_cast<size_t>(end - guess)));
    starts[static_cast<size_t>(t)] = nl ? nl + 1 : end;
  }
  starts[static_cast<size_t>(n_threads)] = end;

  std::vector<std::string> outs(static_cast<size_t>(n_threads));
  std::vector<int> statuses(static_cast<size_t>(n_threads), 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back(convert_chunk, starts[static_cast<size_t>(t)],
                         starts[static_cast<size_t>(t) + 1], &spec,
                         &outs[static_cast<size_t>(t)],
                         &statuses[static_cast<size_t>(t)]);
  }
  for (auto& th : threads) th.join();
  for (int st : statuses) {
    if (st < 0) return st;
  }

  FILE* out = fopen(out_path, "wb");
  if (!out) return -6;
  fwrite(gtrack_header, 1, strlen(gtrack_header), out);
  long long rows = 0;
  for (const auto& o : outs) {
    fwrite(o.data(), 1, o.size(), out);
  }
  fclose(out);
  for (const auto& o : outs) {
    for (char c : o) rows += (c == '\n');
  }

  // report found names
  std::string joined;
  for (size_t i = 0; i < spec.names.size(); ++i) {
    if (i) joined.push_back('\n');
    joined += spec.names[i];
  }
  if (found_buf && found_cap > 0) {
    size_t n = joined.size() < static_cast<size_t>(found_cap - 1)
                   ? joined.size()
                   : static_cast<size_t>(found_cap - 1);
    memcpy(found_buf, joined.data(), n);
    found_buf[n] = '\0';
  }
  return rows;
}

}  // extern "C"
