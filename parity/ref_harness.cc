// Parity benchmark harness: compiles the UNMODIFIED reference engine headers
// (mounted read-only at /root/reference) and runs build + slim conversion +
// search on a dataset, so the JAX engine can be compared against the actual
// reference implementation on identical data. This binary is evaluation
// tooling only — no reference code is incorporated into hnsw_slim_tpu.
//
// Usage:
//   ref_harness <base.fvecs> <query.fvecs> <out.ivecs> <mode: hnsw|slim|slimq>
//               <M> <efc> <ef_list> <k> [threads] [dump.slimgraph]
//               [centroids.fvecs] [clusterids.ivecs]
// mode=slimq additionally needs the kmeans centroids + assignments the
// reference pipeline precomputes (hnsw_slimq_strategy.h:43-46 expects
// *_centroids_16.fvecs / *_clusterids_16.ivecs next to the base file).
// Prints: build_ms, convert_ms, index_bytes, solve_ms_ef<e>, threads.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <vector>

#include <omp.h>

#include "hnswlib/hnswlib.h"
#include "hnswlib/hnswalg_slim.h"
#include "hnswlib/hnswalg_slimq.h"
#include "hnswlib/hnswalg_slimzero.h"

#include "rabitqlib/index/hnsw/hnsw.hpp"

static std::vector<float> read_fvecs(const char* path, int& dim, int& num) {
  std::ifstream f(path, std::ios::binary);
  if (!f) { std::cerr << "cannot open " << path << "\n"; exit(1); }
  f.read(reinterpret_cast<char*>(&dim), 4);
  f.seekg(0, std::ios::end);
  const long long sz = f.tellg();
  const long long row = 4 + 4LL * dim;
  num = static_cast<int>(sz / row);
  std::vector<float> out(static_cast<size_t>(num) * dim);
  f.seekg(0);
  for (int i = 0; i < num; ++i) {
    int d;
    f.read(reinterpret_cast<char*>(&d), 4);
    f.read(reinterpret_cast<char*>(out.data() + static_cast<size_t>(i) * dim),
           4LL * dim);
  }
  return out;
}

static std::vector<int> read_ivecs_flat(const char* path, int& dim, int& num) {
  std::ifstream f(path, std::ios::binary);
  if (!f) { std::cerr << "cannot open " << path << "\n"; exit(1); }
  f.read(reinterpret_cast<char*>(&dim), 4);
  f.seekg(0, std::ios::end);
  const long long sz = f.tellg();
  const long long row = 4 + 4LL * dim;
  num = static_cast<int>(sz / row);
  std::vector<int> out(static_cast<size_t>(num) * dim);
  f.seekg(0);
  for (int i = 0; i < num; ++i) {
    int d;
    f.read(reinterpret_cast<char*>(&d), 4);
    f.read(reinterpret_cast<char*>(out.data() + static_cast<size_t>(i) * dim),
           4LL * dim);
  }
  return out;
}

static void write_ivecs(const char* path, const std::vector<int>& data,
                        int num, int k) {
  std::ofstream f(path, std::ios::binary);
  for (int i = 0; i < num; ++i) {
    f.write(reinterpret_cast<const char*>(&k), 4);
    f.write(reinterpret_cast<const char*>(data.data() + 1LL * i * k), 4LL * k);
  }
}

using Clock = std::chrono::steady_clock;
static double ms_since(Clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(Clock::now() - t0).count();
}

static std::vector<int> parse_ef_list(const std::string& ef_list) {
  std::vector<int> efs;
  size_t pos = 0;
  while (pos < ef_list.size()) {
    size_t comma = ef_list.find(',', pos);
    if (comma == std::string::npos) comma = ef_list.size();
    efs.push_back(atoi(ef_list.substr(pos, comma - pos).c_str()));
    pos = comma + 1;
  }
  return efs;
}

// ---------------------------------------------------------------------------
// dump: export a reference-built slim/slimq CHAL graph topology so the JAX
// engine can serve the exact same graph (same-graph CPU-vs-device comparison,
// and reference-scale builds without paying our device build path).
// Format: u32 magic 'HSLG' | u32 n | i32 maxlevel | u32 entry | i32 Lt |
//   u32 maxM | u32 maxM0 | per node: i32 level | u32 total |
//   u32 end_off[level+1] | i32 ids[total]
// ---------------------------------------------------------------------------
template <typename SlimT>
static int dump_slim_graph(SlimT& slim, const char* path) {
  std::ofstream f(path, std::ios::binary);
  const uint32_t magic = 0x48534C47;
  const uint32_t n = static_cast<uint32_t>(slim.cur_element_count_);
  const int32_t maxlevel = slim.maxlevel_;
  const uint32_t entry = static_cast<uint32_t>(slim.enterpoint_node_);
  const int32_t lt = slim.threshold_level_;
  const uint32_t mm = static_cast<uint32_t>(slim.maxM_);
  const uint32_t mm0 = static_cast<uint32_t>(slim.maxM0_);
  f.write(reinterpret_cast<const char*>(&magic), 4);
  f.write(reinterpret_cast<const char*>(&n), 4);
  f.write(reinterpret_cast<const char*>(&maxlevel), 4);
  f.write(reinterpret_cast<const char*>(&entry), 4);
  f.write(reinterpret_cast<const char*>(&lt), 4);
  f.write(reinterpret_cast<const char*>(&mm), 4);
  f.write(reinterpret_cast<const char*>(&mm0), 4);
  for (uint32_t i = 0; i < n; ++i) {
    char* element = slim.elements_ + 1ULL * i * slim.size_data_per_element_;
    const int32_t lv = static_cast<int32_t>(slim.get_element_level(element));
    const uint32_t total = slim.get_total_neighbor(element);
    f.write(reinterpret_cast<const char*>(&lv), 4);
    f.write(reinterpret_cast<const char*>(&total), 4);
    char* nbrs = slim.get_neighbors(element);
    std::vector<uint32_t> ends(lv + 1, 0);
    if (nbrs != nullptr) {
      for (int32_t l = 0; l < lv; ++l) {
        ends[l] = reinterpret_cast<hnswlib::offsetint*>(nbrs)[l];
      }
    }
    ends[lv] = total;
    f.write(reinterpret_cast<const char*>(ends.data()), 4LL * (lv + 1));
    if (total > 0 && nbrs != nullptr) {
      const auto* ids = reinterpret_cast<const int32_t*>(
          nbrs + sizeof(hnswlib::offsetint) * lv);
      f.write(reinterpret_cast<const char*>(ids), 4LL * total);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// dump the UNPRUNED vanilla HNSW adjacency (per-level link lists) so the JAX
// engine can take over a reference-built index as its mutable serving state
// (update-latency benchmarks at reference scale without paying our build).
// Format: u32 magic 'HNSG' | u32 n | i32 maxlevel | u32 entry | u32 maxM |
//   u32 maxM0 | per node: i32 level | per l in 0..level: u32 cnt | i32 ids[cnt]
// ---------------------------------------------------------------------------
static int dump_hnsw_graph(hnswlib::HierarchicalNSW<float>& h,
                           const char* path) {
  std::ofstream f(path, std::ios::binary);
  const uint32_t magic = 0x484E5347;
  const uint32_t n = static_cast<uint32_t>(h.cur_element_count);
  const int32_t maxlevel = h.maxlevel_;
  const uint32_t entry = static_cast<uint32_t>(h.enterpoint_node_);
  const uint32_t mm = static_cast<uint32_t>(h.maxM_);
  const uint32_t mm0 = static_cast<uint32_t>(h.maxM0_);
  f.write(reinterpret_cast<const char*>(&magic), 4);
  f.write(reinterpret_cast<const char*>(&n), 4);
  f.write(reinterpret_cast<const char*>(&maxlevel), 4);
  f.write(reinterpret_cast<const char*>(&entry), 4);
  f.write(reinterpret_cast<const char*>(&mm), 4);
  f.write(reinterpret_cast<const char*>(&mm0), 4);
  for (uint32_t i = 0; i < n; ++i) {
    const int32_t lv = h.element_levels_[i];
    f.write(reinterpret_cast<const char*>(&lv), 4);
    for (int32_t l = 0; l <= lv; ++l) {
      hnswlib::linklistsizeint* ll =
          l == 0 ? h.get_linklist0(i) : h.get_linklist(i, l);
      const uint32_t cnt = h.getListCount(ll);
      const int* ids = reinterpret_cast<const int*>(ll + 1);
      f.write(reinterpret_cast<const char*>(&cnt), 4);
      f.write(reinterpret_cast<const char*>(ids), 4LL * cnt);
    }
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 9) {
    std::cerr << "usage: ref_harness base query out mode M efc ef_list k"
                 " [threads] [dump] [centroids] [clusterids]\n";
    return 2;
  }
  const char* base_path = argv[1];
  const char* query_path = argv[2];
  const char* out_path = argv[3];
  const std::string mode = argv[4];
  const int M = atoi(argv[5]);
  const int efc = atoi(argv[6]);
  const std::string ef_list = argv[7];  // comma-separated ef sweep
  const int k = atoi(argv[8]);
  const int threads = argc > 9 ? atoi(argv[9]) : 1;
  const char* dump_path = (argc > 10 && std::strlen(argv[10]) > 1)
                              ? argv[10] : nullptr;

  omp_set_num_threads(threads);
  printf("threads %d\n", threads);

  int dim = 0, n = 0, qdim = 0, nq = 0;
  auto base = read_fvecs(base_path, dim, n);
  auto queries = read_fvecs(query_path, qdim, nq);
  const auto efs = parse_ef_list(ef_list);
  std::vector<int> results(static_cast<size_t>(nq) * k);

  hnswlib::L2Space space(dim);

  if (mode == "slimq") {
    // Reference SlimQ pipeline (hnsw_slimq_strategy.h:49-146): rabitqlib
    // quantized HNSW built with precomputed kmeans-16 centroids/assignments,
    // converted to the slim CHAL layout, searched with the 1-bit estimator
    // plus an exact top-K rerank track fed from setDataset.
    if (argc < 13) {
      std::cerr << "slimq mode needs centroids.fvecs + clusterids.ivecs\n";
      return 2;
    }
    int cdim = 0, ncent = 0, iddim = 0, nid = 0;
    auto centroids = read_fvecs(argv[11], cdim, ncent);
    auto cluster_ids_i = read_ivecs_flat(argv[12], iddim, nid);
    std::vector<rabitqlib::PID> cluster_ids(cluster_ids_i.begin(),
                                            cluster_ids_i.end());

    auto* qhnsw = new rabitqlib::hnsw::HierarchicalNSW(
        n, dim, /*total_bits=*/4, M, efc, /*seed=*/100,
        rabitqlib::METRIC_L2);
    qhnsw->setRawData(base.data());
    auto t0 = Clock::now();
    qhnsw->construct(ncent, centroids.data(), n, base.data(),
                     cluster_ids.data(), /*num_threads=*/threads,
                     /*faster_quant=*/true);
    printf("build_ms %.1f\n", ms_since(t0));

    hnswlib::HierarchicalNSWSlimQ<float> slimq(
        &space, static_cast<size_t>(n), M, efc, /*threshold_level=*/0,
        /*top_degree_percent0=*/0.02f, /*top_degree_percent=*/0.02f,
        /*top_degree_M0=*/32, /*low_degree_m0=*/8,
        /*top_degree_M=*/16, /*low_degree_m=*/4);
    t0 = Clock::now();
    slimq.convertFromHNSW(qhnsw);
    printf("convert_ms %.1f\n", ms_since(t0));
    printf("slimq_index_bytes %zu\n", slimq.indexSize());

    // setDataset feeds the exact-rerank track (hnswalg_slimq.h:747-757)
    std::vector<std::vector<float>> data_set(n, std::vector<float>(dim));
    for (int i = 0; i < n; ++i)
      std::memcpy(data_set[i].data(), base.data() + 1LL * i * dim, 4LL * dim);
    slimq.setDataset(&data_set);
    K = static_cast<size_t>(k);  // global top-K (core.h:30)

    std::vector<hnswlib::tableint> out(k);
    for (int ef : efs) {
      slimq.setEf(ef);
      auto t1 = Clock::now();
      // slimq searchKnn uses a shared member search_pool_ — single-thread
      // only (the reference keeps its omp pragma commented out,
      // hnsw_slimq_strategy.h:156).
      for (int i = 0; i < nq; ++i) {
        slimq.searchKnn(queries.data() + static_cast<size_t>(i) * qdim, k,
                        out.data());
        for (int j = 0; j < k; ++j)
          results[1LL * i * k + j] = static_cast<int>(out[j]);
      }
      printf("solve_ms_ef%d %.1f\n", ef, ms_since(t1));
      char path[512];
      snprintf(path, sizeof path, "%s.ef%d", out_path, ef);
      write_ivecs(path, results, nq, k);
    }
    if (dump_path) {
      dump_slim_graph(slimq, dump_path);
      printf("dumped %s\n", dump_path);
    }
    write_ivecs(out_path, results, nq, k);
    delete qhnsw;
    return 0;
  }

  hnswlib::HierarchicalNSW<float> hnsw(&space, n, M, efc);
  auto t0 = Clock::now();
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    hnsw.addPoint(base.data() + static_cast<size_t>(i) * dim, i);
  }
  printf("build_ms %.1f\n", ms_since(t0));
  printf("hnsw_index_bytes %zu\n", hnsw.indexSize());

  if (mode == "slimzero") {
    // reference SlimZero (hnsw_slimzero_strategy.h:41-48 parameters)
    hnswlib::HierarchicalNSWSlimZero<float> sz(
        &space, static_cast<size_t>(n), M, efc, /*threshold_level=*/0,
        /*top_degree_percent0=*/0.02f, /*top_degree_percent=*/0.02f,
        /*top_degree_M0=*/32, /*low_degree_m0=*/8,
        /*top_degree_M=*/16, /*low_degree_m=*/4,
        /*min_indegree0=*/8, /*min_indegree=*/4);
    t0 = Clock::now();
    sz.convertFromHNSW(&hnsw);
    printf("convert_ms %.1f\n", ms_since(t0));
    printf("slimzero_index_bytes %zu\n", sz.indexSize());
    for (int ef : efs) {
      sz.setEf(ef);
      t0 = Clock::now();
#pragma omp parallel for schedule(dynamic) if (threads > 1)
      for (int i = 0; i < nq; ++i) {
        std::vector<unsigned> out(k);
        sz.searchKnn(queries.data() + static_cast<size_t>(i) * qdim, k,
                     out.data());
        for (int j = 0; j < k; ++j) results[1LL * i * k + j] = out[j];
      }
      printf("solve_ms_ef%d %.1f\n", ef, ms_since(t0));
      char path[512];
      snprintf(path, sizeof path, "%s.ef%d", out_path, ef);
      write_ivecs(path, results, nq, k);
    }
    if (dump_path) {
      dump_slim_graph(sz, dump_path);
      std::string hp = std::string(dump_path) + ".hnsw";
      dump_hnsw_graph(hnsw, hp.c_str());
      printf("dumped %s\n", dump_path);
    }
    write_ivecs(out_path, results, nq, k);
    return 0;
  }

  if (mode == "slim") {
    hnswlib::HierarchicalNSWSlim<float> slim(
        &space, static_cast<size_t>(n), M, efc, /*threshold_level=*/0,
        /*top_degree_percent0=*/0.02f, /*top_degree_percent=*/0.02f,
        /*top_degree_M0=*/32, /*low_degree_m0=*/8,
        /*top_degree_M=*/16, /*low_degree_m=*/4);
    t0 = Clock::now();
    slim.convertFromHNSW(&hnsw);
    printf("convert_ms %.1f\n", ms_since(t0));
    printf("slim_index_bytes %zu\n", slim.indexSize());
    for (int ef : efs) {
      slim.setEf(ef);
      t0 = Clock::now();
      // the reference serves slim multi-threaded (hnsw_slim_server.cc uses
      // a threaded httplib server over one shared index)
#pragma omp parallel for schedule(dynamic) if (threads > 1)
      for (int i = 0; i < nq; ++i) {
        std::vector<unsigned> out(k);
        slim.searchKnn(queries.data() + static_cast<size_t>(i) * qdim, k,
                       out.data());
        for (int j = 0; j < k; ++j) results[1LL * i * k + j] = out[j];
      }
      printf("solve_ms_ef%d %.1f\n", ef, ms_since(t0));
      char path[512];
      snprintf(path, sizeof path, "%s.ef%d", out_path, ef);
      write_ivecs(path, results, nq, k);
    }
    if (dump_path) {
      dump_slim_graph(slim, dump_path);
      std::string hp = std::string(dump_path) + ".hnsw";
      dump_hnsw_graph(hnsw, hp.c_str());
      printf("dumped %s\n", dump_path);
    }
  } else {
    const int ef = efs.empty() ? 64 : efs[0];
    hnsw.setEf(ef);
    t0 = Clock::now();
#pragma omp parallel for schedule(dynamic) if (threads > 1)
    for (int i = 0; i < nq; ++i) {
      auto pq = hnsw.searchKnn(queries.data() + static_cast<size_t>(i) * qdim, k);
      for (int j = k - 1; j >= 0 && !pq.empty(); --j) {
        results[1LL * i * k + j] = static_cast<int>(pq.top().second);
        pq.pop();
      }
    }
    printf("solve_ms %.1f\n", ms_since(t0));
  }

  write_ivecs(out_path, results, nq, k);
  return 0;
}
