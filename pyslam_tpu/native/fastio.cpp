// fastio — native text-parsing kernels for the IO layer.
//
// The reference delegates its hot numeric loops to scipy; its *runtime* IO
// (g2o / BAL readers) is pure Python (SURVEY.md §2.1 — and §2.2: the
// reference authored no native code).  At the scales this framework targets
// (Venice-class BAL: 4.65M observations ≈ 25M float tokens, 50k-pose g2o:
// 150k tagged lines) CPython tokenisation becomes the pipeline bottleneck —
// tens of seconds before the first device dispatch.  These two kernels move
// tokenisation to C++ (std::from_chars, single pass, zero allocation);
// everything downstream stays vectorised numpy.
//
// Contract notes:
//  - Both kernels are pure functions of the input buffer; no global state,
//    no locks — safe to call from multiple Python threads (GIL released by
//    ctypes during the call).
//  - Errors return a negative position so Python can raise with context.
//  - Layout/ownership: caller (numpy) owns every buffer; sizes are counted
//    in elements, not bytes.

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' || c == '\f';
}

// Parse one double starting at p (not whitespace); advance p past it.
// Returns false on malformed numeric text.
inline bool parse_one(const char*& p, const char* end, double& out) {
  // std::from_chars does not accept a leading '+'; published g2o/BAL files
  // occasionally carry one.
  if (p < end && *p == '+') ++p;
  auto res = std::from_chars(p, end, out);
  if (res.ec != std::errc()) return false;
  p = res.ptr;
  return true;
}

}  // namespace

extern "C" {

// Count whitespace-separated tokens and lines in one memory-bandwidth pass.
// Callers use the counts to size output buffers exactly (a conservative
// n/2 cap costs hundreds of MB of allocation churn on Venice-scale files).
void ps_count_tokens(const char* buf, long long n, long long* n_tokens,
                     long long* n_lines) {
  long long toks = 0, lines = 0;
  bool in_tok = false;
  for (long long i = 0; i < n; ++i) {
    char c = buf[i];
    if (c == '\n') ++lines;
    bool sp = is_space(c);
    if (!sp && !in_tok) ++toks;
    in_tok = !sp;
  }
  if (n > 0 && buf[n - 1] != '\n') ++lines;
  *n_tokens = toks;
  *n_lines = lines;
}

// Parse every whitespace-separated double in buf[0..n).
// Returns the count parsed (<= cap), or -(byte_offset+1) at the first
// malformed token.  If more than `cap` values are present, parsing stops at
// cap and returns cap+1 as an overflow signal (callers size cap from the
// file's own header or byte count, so this only fires on corrupt input).
long long ps_parse_doubles(const char* buf, long long n, double* out,
                           long long cap) {
  const char* p = buf;
  const char* end = buf + n;
  long long k = 0;
  for (;;) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) return k;
    if (k >= cap) return cap + 1;
    if (!parse_one(p, end, out[k])) return -((long long)(p - buf) + 1);
    ++k;
  }
}

// Tagged-line scanner for g2o-style files.
//
// `tags` is a '\n'-separated registry of K tag strings (no trailing '\n'
// required).  For each nonempty, non-comment line of buf whose first token
// matches a registry entry, parse all following whitespace-separated doubles
// into `fields` and append (tag_id, field_offset, field_count) to the
// per-line output arrays.  Lines whose first token is unknown (or '#'
// comments) are skipped without parsing.
//
// Returns the number of recognised lines, or -(byte_offset+1) at the first
// malformed numeric token, or line_cap+1 / -(field_cap+2) on output
// overflow (callers size outputs from the byte count, so again only corrupt
// input fires these).
long long ps_scan_tagged(const char* buf, long long n, const char* tags,
                         long long tags_len, int* tag_ids, long long* offs,
                         int* counts, long long line_cap, double* fields,
                         long long field_cap) {
  // Registry: pointers+lengths into `tags` (K is small — linear probe with
  // a first-char filter is faster than hashing at K ~ 15).
  constexpr int kMaxTags = 64;
  const char* tag_ptr[kMaxTags];
  int tag_len[kMaxTags];
  int K = 0;
  {
    const char* t = tags;
    const char* tend = tags + tags_len;
    while (t < tend && K < kMaxTags) {
      const char* s = t;
      while (t < tend && *t != '\n') ++t;
      if (t > s) {
        tag_ptr[K] = s;
        tag_len[K] = (int)(t - s);
        ++K;
      }
      if (t < tend) ++t;
    }
  }

  const char* p = buf;
  const char* end = buf + n;
  long long nl = 0;   // recognised lines
  long long nf = 0;   // fields written
  while (p < end) {
    // First token of the line.
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    const char* tok = p;
    while (p < end && !is_space(*p)) ++p;
    int tlen = (int)(p - tok);
    int id = -1;
    for (int k = 0; k < K; ++k) {
      if (tag_len[k] == tlen && tag_ptr[k][0] == tok[0] &&
          std::memcmp(tag_ptr[k], tok, (size_t)tlen) == 0) {
        id = k;
        break;
      }
    }
    if (id < 0) {  // unknown tag / comment: skip to end of line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    if (nl >= line_cap) return line_cap + 1;
    long long start = nf;
    for (;;) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      if (nf >= field_cap) return -(field_cap + 2);
      if (!parse_one(p, end, fields[nf])) return -((long long)(p - buf) + 1);
      ++nf;
    }
    tag_ids[nl] = id;
    offs[nl] = start;
    counts[nl] = (int)(nf - start);
    ++nl;
  }
  return nl;
}

}  // extern "C"
