#!/usr/bin/env python3
#
# Smoke run of the PyTorch/CUDA port (spark_rapids_ml_tpu_torch) on one
# NVIDIA GPU.  From the root of the repository:
#
#     python3 chip_smoke.py
#
# Phases, one JSON line each; any failure raises and exits non-zero:
#   env      torch/CUDA versions and the card (nvidia-smi name, power limit)
#   build    nvcc of every kernel of the port, all started together
#   kernels  each kernel's wrapper against its plain PyTorch version on the
#            card, at the shapes below: exact agreement on data whose sums are
#            exact in fp32, min_d2 within 1e-4 on continuous data (argmin may
#            differ there only on rows whose two best distances are within
#            1e-5 relative); median times of the kernel, the plain version,
#            the unfused PyTorch composition (library_ms, a yardstick only),
#            and the least time the card could take (bound_ms).  B1 (float32,
#            the pipelined loop of csrc/fp32_dist_tile.cuh) also at two
#            large shapes of its 4-byte copies (SHAPES_UNALIGNED: X one
#            element off a 16-byte boundary, and d % 4 != 0), each record
#            naming its copy width; float64 exact at the first four shapes
#   path     the KMeans flagship configuration through the public API:
#            1,000,000 x 3000 float32 Gaussian blobs around 1000 centers,
#            KMeans(k=1000, maxIter=30, initMode="random").fit -> transform ->
#            save -> load -> transform
#   kernels_forest
#            the RandomForest kernels against their plain versions: binning
#            (B2) exact at the path's shape (1,000,000 x 3000, 127 edges),
#            ragged shapes and NaN / +-inf / on-edge values; node histograms
#            (B3) through both routes, the tensor-core kernel and the atomic
#            kernel, at ragged shapes and at the first launch of every
#            shallow split level of both flagship fits (classifier F_pad 64,
#            levels 0-6; regressor F_pad 1024, levels 0-5), and bucketed
#            histograms (B4) at one deep window (each block writes its own
#            output slice), at its level 7, with the fit's zero-padded
#            feature rows, and at a launch too small to fill the card (rows
#            split across blocks, atomic flush), with stray node ids and
#            bins, every output on a block of NaNs; the atomic kernel also
#            through the int32 cells of declared integer stats (the
#            classifier's): exact on integer stats,
#            within HIST_FLOAT_RTOL / HIST_FLOAT_ATOL on float stats, the
#            tensor-core route bit for bit across two calls on float stats;
#            timings as above (library_ms: torch.searchsorted, index_add_;
#            B3's plain version and index_add_ timed at every classifier
#            level and at the regressor's level 0 only, its plain version
#            taking seconds a call at F_pad 1024)
#   path_rf_clf
#            RandomForestClassifier(numTrees=50, maxDepth=13, maxBins=128,
#            featureSubsetStrategy="sqrt") on 1,000,000 x 3000 float32 rows
#            (make_classification semantics, 2 classes): fit -> transform ->
#            save -> load -> transform, identical predictions, every forest
#            kernel launched by the fit (B3's launches by route as the
#            route function sends them), held-out accuracy (100k rows) above
#            the majority share
#   path_rf_reg
#            RandomForestRegressor(numTrees=30, maxDepth=6, maxBins=128,
#            featureSubsetStrategy="onethird") on the same rows with a linear
#            target: fit -> transform, finite predictions, held-out R^2 > 0
#   forest_card_vs_cpu
#            one reduced fit (65,536 x 256, 4 trees, depth 13, no bootstrap)
#            on the card and under use_device("cpu"): identical trees
#   kernels_knn
#            the exact-kNN kernels against their plain versions: candidate
#            pool (B5, and B6, the same kernel on the audit route), fused
#            merge (B7), audit count (B8).  On integer-valued data (ragged
#            shapes, one flagship block, the mesh's shard shape, m = 32)
#            pools (-inf slots included), merges and counts are exact, a
#            pool wider than 16,384, 65,537 groups, groups ending inside
#            an item tile, and B5's and B8's 4-byte copies (d % 4 != 0, and
#            misaligned views at d % 4 == 0) included; the pool kernel's
#            ptxas registers and spills and its resident blocks an SM;
#            given one pool, B7 is bit-exact on Gaussian data too, and on
#            tied pools with k past one 4,096-rank window and past the pool;
#            the flagship block's merged distances agree with the plain
#            route within KNN_DIST_RTOL, and the count equals the merged
#            lists on every unflagged row; timings as above, B5 also at the
#            mesh's shard shape and at m = 32 (library_ms: matmul + a
#            per-group topk, topk over the pool, matmul + a compare-sum);
#            B7's route at each launch shape, its radix kernel bit for bit
#            on a wide tied pool at each (CTAs a row, threads a CTA) the
#            route can pick, its ptxas registers and spills, resident
#            clusters, and the windowed kernel (the first design) timed
#            beside it
#   path_knn the JAX package's kNN arm: NearestNeighbors(k=200).fit on
#            400,000 x 3000 float32 items (standard normal, seed 0, 8
#            partitions), kneighbors of 16,384 queries (seed 7, 2
#            partitions) twice (staging + search, then the cached call), one
#            profiled call, 1,024 sampled queries against float64 brute force
#            on the card, exactNearestNeighborsJoin of 1,000 queries
#   knn_audit
#            one 8,192-query block through the audit route (B6 + B7 + B8):
#            every row the count check fails is flagged too, and the results
#            equal the main path's
#   knn_streamed
#            the same items under an item budget of KNN_STREAM_BUDGET bytes:
#            kneighbors of 2,048 queries streams them through in 3 blocks;
#            the device never holds two blocks (peak memory of the call under
#            two blocks' bytes), and the results pass the float64 check
#   kernels_exchange
#            the ring shift (B11) against its plain version on 4 shards of
#            the card, bit for bit: the ring hop's blocks (2,048 x 3000 f32
#            queries, 2,048 x 200 f32 and i32 candidates) at shifts 1, -1, 3,
#            misaligned blocks, two gateway cycles, the typed rejections;
#            device times from a trace (library_ms: torch.roll of the
#            stacked blocks).  kernels_exchange_peer runs the same cases over
#            cuda:0 .. n-1 through peer pointers, or says it was skipped on a
#            host with one card
#   path_knn_mesh
#            path_knn's arm on a 4-shard mesh of the card
#            (use_device(["cuda:0"] * 4), NearestNeighbors(k=200,
#            num_workers=4)): fit, kneighbors twice, one profiled call, B5
#            once per shard per block and B7 once per block, the float64
#            check, ids equal to path_knn's off near-ties
#   knn_ring one 8,192-query block through the exact exchange on that mesh,
#            ring and gather (equal bit for bit; 12 B11 launches on the ring,
#            none on the gather; the section bytes of the per-hop model), and
#            through the one-shard exchange (distances within 1e-6, ids equal
#            off near-ties); a ragged 37-row block, padded onto the ring (12
#            B11 launches), against the block's rows; one profiled ring call
#            gives B11's share
#   kernels_ann
#            B7 at the ANN arms' pool (414 query rows x 158 lists x 2048
#            slots, ~69% -inf) at k = 200 / 800 / 1600: bit for bit against
#            its plain version on tied integer values, through its route and
#            the windowed kernel, and timed on continuous values beside
#            torch.topk; the IVF-PQ lookup-table kernels against their plain
#            versions, bit for bit: B9 (one-byte codes; the contiguous form
#            and lut_accumulate_probed, which reads the probed lists in
#            place) and B10 (fast-scan) at the JAX package's test shapes,
#            ragged R, ksub < 256 / < 16 with codes past it, tables staged in
#            parts, misaligned codes, 65,537 queries, ragged counts and slots
#            outside the plane; lut_accumulate_probed at the 8-bit arm's
#            launch (150 queries x 158 lists of 2048 rows, m_sub 32), resident
#            and through a tier's pool planes, timed there (library_ms:
#            index_select + gather + sum over j) with its blocks a query and
#            the blocks an SM holds; fastscan_lut_accumulate_probed the same
#            way at the 4-bit arm's launch (237 queries x 158 lists of 2048
#            rows, 16 packed bytes a row; library_ms: index_select + unpack +
#            gather + sum) and B10's contiguous form at 237 x 323,584 rows;
#            their ptxas registers; B10's typed rejections on both entries; B1 at the ANN fit's shapes (400,000 x 256 vs 632
#            centroids, 400,000 x 8 vs 256 codewords)
#   path_ann / path_ann_pq / path_ann_pq4
#            the JAX package's ANN arms (bench.py:379-442): 400,000 x 256
#            clustered float32 items (8 partitions), 8,192 queries (their
#            first rows, 2 partitions; cut from the arms' 16,384 for time), k = 200, nlist 632, nprobe 158;
#            IVF-Flat, IVF-PQ (M 32, 8 bits, refine_ratio 4) and IVF-PQ
#            fast-scan (M 32, 4 bits, opq, refine_ratio 8): fit, kneighbors
#            twice (staging, then the cached call), one profiled call of
#            its first 2,048 queries; B1 in every fit, B7 in every search, B9 (lut_accumulate_probed)
#            only in the 8-bit and B10 only in the 4-bit search; then, on 2,048 queries, recall@10
#            and @200 against exactSearch=True (gates 0.95 flat, 0.9
#            refined PQ), the ADC-only recall of the PQ arms, save -> load
#            identical, B7 against lex_topk on one probed block, and (4-bit)
#            hot_fraction 0.5 bitwise the resident search
#   path_pca the reference benchmark's PCA (k = 3) on 1,000,000 x 3000
#            float32 low-rank rows (rank 32 plus 0.1 noise, bench.py's):
#            fit -> transform -> save -> load -> transform (identical), the
#            fitted mean, components (signs equal), variance ratio and
#            singular values against the float64 covariance and float64 eigh
#            of the same rows on the card (PCA_* gates), projections against
#            float64, TF32 off (the settings and an X^T X probe against
#            float64), stage times (ingest, moments, covariance, float64
#            eigh), a profiled fit
#   path_linreg
#            LinearRegression OLS, ridge (regParam 1e-5) and elastic net
#            (regParam 1e-5, elasticNetParam 0.5, maxIter 10) from one frame
#            of 1,000,000 x 3000 Gaussian rows, y = X . coef + 0.1 noise:
#            each fit -> transform -> save -> load -> transform (identical)
#            and held-out R^2 > 0.99 (100,000 rows); OLS and ridge against a
#            float64 solve of the float64 normal equations (LINREG_RTOL) and
#            the port's solve on the float64 statistics against it
#            (LINREG_F64_RTOL); elastic net against the port's CD on the CPU
#            from the card's statistics (ENET_RTOL, sweeps equal); one CD
#            sweep eager and as its CUDA graph's replay; a profiled ridge fit
#   path_logreg
#            binary LogisticRegression(regParam 1e-5, maxIter 200) on the
#            same rows, y > 0: fit -> transform -> save -> load -> transform
#            (identical), held-out accuracy > 0.9, L-BFGS iterations,
#            evaluations and convergence, one objective evaluation (X read
#            twice) against its bound, a profiled fit
#   path_logreg_sparse
#            multinomial LogisticRegression(regParam 1e-5, maxIter 100, tol
#            1e-6) on 4,000,000 x 100 CSR rows (one nonzero a row, 4 classes;
#            bench.py's sparse arm): two fits bit for bit, peak device memory
#            under the dense features' 1.6 GB, accuracy above the majority
#            share, transform, one evaluation timed, a profiled fit
#   glm_card_vs_cpu
#            PCA, the three linear fits and four logistic fits (binary and 4
#            classes, dense and CSR) at 65,536 x 256 on the card and under
#            use_device("cpu"), within the CVC_* tolerances
#   path_fit_mesh
#            the batch cells' estimators on a 4-shard mesh of the card
#            (use_device(["cuda:0"] * 4), num_workers 4: the row-sharded
#            ingest and the fit reductions over shards), each part right
#            after the path that makes its rows and emitted at once, the
#            record after the GLM phases: KMeans (the flagship on path's
#            rows against path's model: n_iter equal, inertia within 1e-4
#            relative, at most 1e-4 of the labels differing, every center
#            no differing label touches within 1e-2; transform with its 8
#            B1 launches); PCA
#            (k 3, path_pca's rows, at its PCA_* gates against its float64
#            reference); OLS (path_linreg's rows, within LINREG_RTOL of its
#            float64 solve); binary logistic (path_logreg's rows, held-out
#            accuracy > 0.9, coefficients within CV_LOGISTIC_ATOL of its
#            model); RandomForestRegressor through the scatter engine on
#            path_rf_reg's rows at its widths, MESH_RF_TREES trees (B2 once
#            a shard, no histogram kernel, held-out R^2 > 0, the engine's
#            histogram and split seconds a level).  Each part records
#            fit_s, its ingest seconds, peak memory and the exchange bytes
#            by section.  Needs path, path_pca, path_linreg, path_logreg and
#            path_rf_reg
#   path_fit_ranks
#            the multi-controller layer (parallel/runner.py, context.py):
#            chip_smoke.py spawns 2 worker processes of itself (--rank r
#            --nranks 2 --job DIR), each on use_device(["cuda:0"] * 2), so 2
#            ranks x 2 shards make path_fit_mesh's 4 global shards; the
#            ranks bootstrap torch.distributed (gloo by the backend rule: two
#            ranks share the card) and meet over a FileControlPlane for the
#            fits and a TcpControlPlane for the kNN.  Each rank makes only its
#            own rows (the generators' streams, stream_rows; the labels come
#            from the paths as files), fits through one
#            DistributedFitSession path_fit_mesh's KMeans (k 1,000 random
#            init), PCA (k 3), OLS and binary logistic, and
#            mesh_card_vs_cpu's integer forest (16,384 x 64, 4 trees, B2
#            once a shard: the flagship regressor was cut when the script
#            passed 1,100 s, RANKS_FITS), and runs distributed_kneighbors
#            on path_knn's items (200,000 a rank) for its first 4,096
#            queries (2,048 a rank, k 200) through the ring and the
#            allgather routes.  Gates: every model bit for bit the 4-shard
#            model (path_fit_mesh's, the forest mesh_card_vs_cpu's
#            card_4_shards; the first differing field reported), the
#            parent's KMeans model's
#            transform launching B1 once a partition, both routes'
#            distances bit for bit path_knn_mesh's and their ids too but
#            for the order inside a run of equal distances (the ranks'
#            merge orders a tie by rank, one search by position): each run
#            below the k-th distance holds path_knn_mesh's ids, and the run
#            at the k-th distance distinct ids of items at exactly that
#            distance, which path_knn_mesh's search at k + KNN_TIE_SLACK
#            lists; and a second pair of
#            ranks whose rank 1 is killed at runner.fit (SRML_FAULTS, action
#            die) surfacing on rank 0 as a typed control-plane error within
#            RANKS_KILL_S, every process ended.  Records the backend and the
#            bootstrap seconds, each fit's seconds and each rank's ingest
#            seconds, the cross-process bytes by section, the control-plane
#            rounds and bytes, each rank's kernel launches, the kNN rows/s a
#            route beside path_knn_mesh's; on a host with 2 or more cards the
#            fits again with one rank a card over NCCL.  Needs path_fit_mesh,
#            mesh_card_vs_cpu, path_knn and path_knn_mesh
#   path_spark
#            the Spark executor routes (spark/adapter.py) through a stand-in
#            of the pyspark surface installed for the phase (no pyspark on
#            the card host; frames of port Partition batches, barrier tasks
#            as threads with a real allGather rendezvous), on rows other
#            phases made: KMeans with path's parameters fitted on path's
#            partitions 0-1 (2 x 125,000 rows) through one barrier task
#            (runner.run_distributed_fit) and transformed on the executors
#            (B1 once a partition, an int prediction column), OLS on the
#            same rows (y = X w + noise, SPARK_SEED) fitted through the
#            barrier task and scored by _transformEvaluate(rmse) on the
#            executors, each bit for bit the port's local route on a port
#            DataFrame of the same partitions; and NearestNeighbors(k=200)
#            on path_knn's items kneighbors of its first 4,096 queries in a
#            barrier stage of 2 tasks (each task one one-shard slice of the
#            card, B5 and B7 counted a task, the host merges of candidate
#            lists (ops/knn.topk_merge) counted and timed), the result sorted by query id
#            and equal to path_knn_mesh's kept results up to the order of a
#            tie run.  Each part prints its seconds and rows/s at once.
#            Needs path, path_knn and path_knn_mesh
#   mesh_card_vs_cpu
#            at 65,536 x 256 integer rows (16,384 x 64 for the forest), each
#            estimator on 4 shards of the card, 1 shard of the card and 8
#            shards of the CPU (use_device(["cpu"] * 8)): KMeans centers
#            (one init), PCA moments, linear and fold statistics and the
#            forest's five arrays (RandomForestRegressor, depth 14: the
#            scatter engine on every mesh, bootstrap on) bit for bit, the
#            fitted PCA, linear and logistic models within the CVC_*
#            tolerances; node_histograms_sharded (B3 on each of 4 card
#            shards, one psum) bit for bit node_histograms over all rows
#            and its plain version
#   path_ann_mesh
#            each ANN arm's fitted model (path_ann, path_ann_pq, path_ann_pq4)
#            searched on use_device(["cuda:0"] * 4) right after its arm, on
#            the arm's profiled 2,048 queries: the index list-sharded, each
#            shard scoring its own probed lists (B9 / B10 at a count of 0
#            for the others), the shards' k best merged by ann.probe_merge
#            and one more B7.  Gates: ids and distance bits equal to the
#            arm's one-shard results, recall@10 at the arm's gate, the 4-bit
#            arm tiered (hot 0.5) bit for bit resident.  Records rows/s,
#            stage seconds, the ann.select / ann.scan / ann.merge ranges of a
#            profiled call of 1,024 queries, exchange calls and bytes, B7 /
#            B9 / B10 launches, peak memory, and (flat) one shard's scoring
#            launch in both tile designs.  Needs an ANN arm
#   path_live_mesh
#            path_stream's live-index script (10 adds of 10,000 rows,
#            50,000 deletes, the repacking add) on a 4-shard holder of the
#            same payload, right after the live index part: searches of
#            2,048 queries before and after, and to_packed(), bit for bit the
#            one-shard holder's; no deleted id; B1 11, B7 counted.  Needs
#            path_stream
#   path_umap_mesh
#            path_umap's fit on 4 shards from its own kNN graph
#            (precomputed_knn), right after its second fit: the embedding
#            bit for bit path_umap's, 200 umap.layout_rows all-gathers.
#            Needs path_umap
#   ann_mesh_card_vs_cpu
#            16,384 x 64 integer rows (nlist 64, nprobe 8, 256 queries): the
#            flat, 8-bit and tiered 4-bit searches, a live index through an
#            add / delete / repack script and a 20-epoch layout of 4,096
#            rows on 4 card shards, 1 card shard and 8 CPU shards, bit for
#            bit
#   path_cv_linreg
#            CrossValidator(LinearRegression(standardization=False)) over
#            regParam geomspace(1e-3, 1, 4) x elasticNetParam {0, 0.5}, 3
#            folds, RegressionEvaluator(rmse), on path_linreg's 1,000,000 x
#            3000 rows: the batched sweep (one staged dataset: ingest.staged
#            1), its stage times, fold 0's best and a CD lane against solo
#            fits on fold 0's train frame (LINREG_RTOL), a repeat sweep with
#            the grid shifted 2x capturing no CD graph, and the fold loop
#            timed once
#   path_cv_logreg
#            CrossValidator(LogisticRegression(maxIter=100)) over the same
#            grid and rows, y > 0, MulticlassClassificationEvaluator(accuracy):
#            two families of 12 lanes (L-BFGS, OWL-QN), their iterations,
#            evaluations and ms an evaluation against X read twice, the best
#            lane against its solo fit on fold 0 (CV_LOGISTIC_ATOL, num_iters
#            within CV_ITER_SLACK), a profiled sweep's idle share
#   path_cv_rf
#            CrossValidator(RandomForestRegressor(numTrees=30, "onethird"))
#            over maxDepth {4, 6}, 3 folds, on path_rf_reg's rows (run while
#            they exist): one B2 a fold and the refit, B3's launches by route
#            as _hist_route sends them for the 6 fits and the refit, fold 0's
#            combined transform-evaluate equal to each sub-model's own
#            evaluate(transform)
#   cv_card_vs_cpu
#            at 65,536 x 256 integer-valued rows: the batched sweep against
#            the fold loop on the card (linear bit for bit, logistic
#            avgMetrics exactly on margin-separated labels), the card against
#            use_device("cpu"), a KMeans CV (k {4, 8}, ClusteringEvaluator,
#            B1 in the scored transforms) against a float64 silhouette,
#            Pipeline and CrossValidatorModel save -> load
#   path_umap
#            UMAP(n_neighbors=15, n_components=2, n_epochs=200,
#            random_state=1, spectral init) on 1,000,000 x 128 float32 rows
#            around 100 blobs (seed 1), 100,000 more held out: fit_s and its
#            phases (umap.knn, the self-join through B5 -> B7; umap.graph,
#            the assembly; umap.init; umap.layout), 2 graph uploads and
#            ceil(200 / 50) layout dispatches, the graph against float64 on
#            1,024 rows (the kNN gate, the self slot apart: how many self
#            distances are > 0 and the largest), P and the edges, 10 layout
#            epochs timed and profiled (ms an epoch, idle share, bound),
#            the JAX package's quality gates (blob centroids apart,
#            trustworthiness k = 10 on 5,000 rows in float64, held-out rows
#            at their blob's fit centroid), the held-out transform's rows a
#            second, save -> load -> an equal transform, a second fit bit
#            for bit, B5 and B7 at the self-join's launch block against
#            their plain versions (exact on integer data) and timed, and a
#            fit at the JAX bench arm's shape (50,000 x 128 standard normal)
#   umap_card_vs_cpu
#            at 20,000 x 32 blob rows and one graph from the card: threefry
#            bits, uniform, randint and the random init at the layout's and
#            the transform's shapes equal bit for bit on the card and under
#            use_device("cpu"), normal within 4 ulps, the layout assembled
#            on both equal (degrees, starts, P, each head's (tail, weight)
#            set), and a fit on each within 0.01 k=15 neighbour preservation
#            (`chip_smoke.py --phases path_umap,umap_card_vs_cpu` runs both)
#   path_stream
#            the streaming engines at the flagship configurations, uncut,
#            through est.streaming().partial_fit / finalize in contiguous
#            chunks, each run beside the path that makes its rows (the
#            record is emitted after the UMAP phases):
#            LinearRegression (OLS) on path_linreg's 1,000,000 x 3000
#            rows in 8,192-row chunks against the batch fit of the same rows
#            (LINREG_RTOL) with held-out R^2; the JAX bench arm's 400,000 x
#            512 stream; 10 chunks profiled (host /
#            copy / kernel time, idle share); LogisticRegression (path_logreg's
#            params) in 65,536-row chunks, held-out accuracy; PCA(k=3) on
#            path_pca's rows against its batch fit (the PCA gates); KMeans
#            (the KMeans cell's k, init, maxIter, seed) on its rows: the
#            running centers' inertia on 65,536 held-out rows falling at
#            each third, save -> load bit for bit; each engine's
#            streaming_ingest_rows_per_s (from the second chunk on) and
#            finalize_s.  Then the live index on path_ann's items (IVF-Flat,
#            nlist 632, nprobe 158, k 200): mutable_index(), kneighbors of
#            the 8,192 queries, 10 adds of 10,000 rows from the same blobs
#            (B1 once each, counted), 50,000 deletes (no deleted id on 2,048
#            queries; B7 against lex_topk on the tombstoned pool), one add
#            overflowing L_pad (a repack), kneighbors again (B7, counted):
#            add rows/s, delete and repack seconds, kneighbors rows/s
#            before and after, recall@10 >= 0.95 against exactSearch over
#            the frozen live set, freeze -> save -> load identical; B1 at
#            the add's shape against its plain version
#   stream_card_vs_cpu
#            at 65,536 x 256 integer rows in 8,192-row chunks, each engine on
#            the card and under use_device("cpu"): linear and PCA states bit
#            for bit; KMeans (the CPU engine adopting the card's first
#            chunk, its init) sums, counts and anchor bit for bit, cost
#            within 1e-6; logistic within 1e-3; a live index (nlist 256) after
#            the same add / deletes / regrowing add / deletes on both, and
#            on the card tiered (hot_fraction 0.5, pinned host mirrors):
#            to_packed() equal, search ids and distances bit for bit
#            (`chip_smoke.py --phases path_stream,stream_card_vs_cpu`)
#   path_serve
#            the online layer (spark_rapids_ml_tpu_torch.serving) over the
#            models the path phases fit, each served right after its path
#            while its rows exist: KMeans (path), the RF classifier
#            (path_rf_clf), OLS and binary logistic (path_linreg,
#            path_logreg), PCA (path_pca), exact kNN (path_knn), IVF-Flat
#            and 8-bit IVF-PQ (path_ann, path_ann_pq).  One ModelServer a
#            model at max_batch 256, max_wait_ms 5, min_bucket 16; 4 client
#            threads send requests of 1-64 rows of the path's rows (2,000 a
#            model, 500 kNN and IVF-Flat, 200 IVF-PQ).  Gates: on 1,024 rows
#            served == the batch call (KMeans labels off near-ties, forest
#            outputs equal, GLM / PCA rtol = atol = 1e-5, kNN ids off
#            near-ties and distances rtol 1e-5, ANN ids off ties);
#            assert_steady_state() (zero warm-ups after the warm-up) on
#            every server; a 2-replica Router of the KMeans model on the one
#            card swapped under traffic to its centers reversed with zero
#            failed requests and every later answer the new model's; one
#            worker death injected through the port's faults site,
#            recovered; path_stream's live IVF-Flat index refreshed into
#            that Router through a StreamingSession, an add after the
#            refresh found by a served search (then deleted again).
#            Records rows/s, latency percentiles, the mean batch, dispatch
#            ms by bucket, B1 / B5 / B7 / B9 launches, B1 and B5 / B7 at the
#            serving buckets (CUDA events), the KMeans traffic's device idle
#            share, the recovered worker's first dispatches.  Needs path;
#            serves only the models of the path phases that run with it.
#   path_serve_lanes
#            multiplexed serving and autoscaling (MultiplexServer, Router.
#            scale_to / replace_replica, Autoscaler) over path_serve's models,
#            each part right after path_serve's part of the same model:
#            (a) 16 KMeans variants (the fitted centers rolled by i rows) on
#            4 resident lanes at k 1,000, D 3,000; 1,000 requests of 1-64 of
#            path's rows from 4 clients (up to 8 outstanding each), tenants
#            drawn Zipf (s = 1.1): each multiplexed batch launches B1 once
#            per distinct lane; (b) 256 OLS variants (coef x (1 + i/256),
#            intercept + i) on 32 resident lanes, 8 binary logistic and 8 PCA
#            (k 3) variants, 500 requests each; (c) path's KMeans model behind
#            a 1-replica router under an Autoscaler (1-3 replicas, windows
#            and cooldowns shortened, ticks every 0.1 s): a 16-client burst
#            until it scales up to 3, idle until a scale_down, then one
#            replica killed through the serving.dispatch fault site with its
#            restart budget spent until the repair.  Gates: every KMeans
#            tenant's 1,024 rows (64-row requests) bit for bit its dedicated
#            ModelServer's labels; every GLM / PCA tenant within rtol = atol =
#            1e-5 of its dedicated server; 0 steady-state warm-ups with
#            paging and on every new replica; 0 failed client requests; the
#            journal holds scale_up, scale_down and repair.  Records rows/s
#            (beside path_serve's dedicated rows/s), latency percentiles, the
#            mean batch, distinct lanes (B1 launches) per batch, page-ins,
#            page-in ms, hits, evictions, the scale-up latency (decision to
#            in rotation) and the new replicas' first dispatches.  Needs
#            path_serve, path, path_linreg, path_logreg and path_pca.
# The fit-input cache is emptied before each timed fit and ingest, so the
# phases time cold fits.
# Every path runs with all kernel launch counters reset just before it and
# read just after (the PCA and GLM paths run no kernel of the port's own:
# their launches stay 0; path_stream resets them before each engine and
# before the live index's mutations, whose adds launch B1 and searches B7).  It ends with the card's nvidia-smi line, a
# {"kernels": [...]} summary line and {"ok": true, "device": {...}}.
# `--phases a,b` runs a subset (the summary then lists only what ran;
# knn_audit, knn_streamed and path_knn_mesh need path_knn, knn_ring needs
# path_knn_mesh; path_serve needs path; path_serve_lanes needs path_serve,
# path, path_linreg, path_logreg and path_pca; path_fit_mesh needs path,
# path_pca, path_linreg, path_logreg and path_rf_reg; path_fit_ranks needs
# path_fit_mesh, mesh_card_vs_cpu, path_knn and path_knn_mesh; path_spark
# needs path, path_knn and path_knn_mesh; path_ann_mesh needs
# an ANN arm, path_live_mesh path_stream, path_umap_mesh path_umap; the ANN,
# PCA, GLM, mesh_card_vs_cpu, ann_mesh_card_vs_cpu, model-selection, UMAP
# and streaming phases need nothing else).
#
# Imports neither jax, nor pandas, nor the JAX package.
#

import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # emit's script_s counts from here

# The flagship KMeans configuration of the reference benchmark
# (k=1000, maxIter=30, initMode=random on 1M x 3000 float32).
ROWS, COLS, K, MAX_ITER, PARTITIONS, SEED = 1_000_000, 3000, 1000, 30, 8, 1
# Shapes of the kernel check: the JAX package's kernel-test shapes, its
# low-d/large-k shape, a slice of the flagship, and the flagship's
# per-partition shape (what transform hands the kernel).
SHAPES = [
    (300, 70, 33),
    (512, 256, 128),
    (129, 1, 2),
    (64, 515, 700),
    (131072, 32, 16384),
    (262144, COLS, K),
    (ROWS // PARTITIONS, COLS, K),
]
# B1's 4-byte-copy instantiation at large n: the flagship's per-partition
# shape with X one element past a 16-byte boundary, and d % 4 != 0
SHAPES_UNALIGNED = [(ROWS // PARTITIONS, COLS, K, True), (131072, 515, K, False)]
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
TIE_RTOL = 1e-5
MIN_D2_TOL = 1e-4


def emit(obj):
    """Print one record; a phase's record also carries script_s, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps):
    """Median over `reps` timed runs (CUDA events) after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n, d, k, itemsize):
    """The larger of operations over the fp32 peak and bytes (each input read
    once, each output written once) over the memory rate."""
    ops = 2.0 * n * k * d
    nbytes = itemsize * (n * d + k * d + n + k) + n * (itemsize + 4)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def plain_top2(torch, X, C, x_norm, c_norm, block_bytes=1 << 28):
    """Plain PyTorch (best d2, argmin, second-best d2) of every row."""
    n, k = X.shape[0], C.shape[0]
    rows = max(1, block_bytes // (4 * k))
    best = torch.empty(n, dtype=X.dtype, device=X.device)
    second = torch.empty(n, dtype=X.dtype, device=X.device)
    arg = torch.empty(n, dtype=torch.int64, device=X.device)
    for lo in range(0, n, rows):
        sl = slice(lo, min(lo + rows, n))
        d2 = x_norm[sl, None] - 2.0 * (X[sl] @ C.T) + c_norm[None, :]
        best[sl], arg[sl] = torch.min(d2, dim=1)  # the first index on ties
        second[sl] = (
            torch.topk(d2, 2, dim=1, largest=False).values[:, 1] if k > 1 else math.inf
        )
    return best, arg, second


def near_ties(best, second):
    return (second - best) <= TIE_RTOL * second.abs()


def b1_input(torch, X, dev, misaligned):
    """X on the card; misaligned: its first element one float past a
    16-byte boundary (a view into a buffer one element longer), so every
    row start is misaligned at any d."""
    if not misaligned:
        return X.to(dev)
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=dev)
    buf[1:].copy_(X.reshape(-1))
    return buf[1:].view(X.shape)


def check_kernel_shape(torch, nc, n, d, k, gen, dev, misaligned=False):
    """One shape: exact and continuous-data agreement, then timings."""
    # exact: values on a 1/4 grid keep every product and partial sum exact
    # in fp32, so any summation order gives the same d2, and a duplicated
    # center makes exact ties that must resolve to the lower index
    X = b1_input(torch, (torch.randn(n, d, generator=gen) * 4).round().div(4), dev, misaligned)
    C = (torch.randn(k, d, generator=gen) * 4).round().div(4).to(dev)
    if k > 1:
        C[k - 1] = C[0]
    copy = nc.copy_bytes(X, C)
    check((copy == 4) == (misaligned or d % 4 != 0), f"({n},{d},{k}) takes {copy}-byte copies")
    m, a = nc.min_dist_argmin(X, C)
    pm, pa = nc.min_dist_argmin_plain(X, C)
    torch.cuda.synchronize()
    exact_mismatch = int((a != pa).sum())
    exact_err = float((m - pm).abs().max())
    check(exact_mismatch == 0 and exact_err == 0.0,
          f"({n},{d},{k}) exact data: {exact_mismatch} argmin mismatches, max err {exact_err}")
    # continuous: standard normal
    X = b1_input(torch, torch.randn(n, d, generator=gen), dev, misaligned)
    C = torch.randn(k, d, generator=gen).to(dev)
    x_norm, c_norm = nc.squared_norms(X), nc.squared_norms(C)
    m, a = nc.min_dist_argmin(X, C, x_norm, c_norm)
    best, parg, second = plain_top2(torch, X, C, x_norm, c_norm)
    torch.cuda.synchronize()
    differ = a.long() != parg
    ties = near_ties(best, second)
    err = float((m - best).abs().max())
    check(bool(torch.allclose(m, best, rtol=MIN_D2_TOL, atol=MIN_D2_TOL)),
          f"({n},{d},{k}) min_d2 off by up to {err}")
    check(not bool((differ & ~ties).any()),
          f"({n},{d},{k}) {int((differ & ~ties).sum())} argmin mismatches off near-ties")
    reps = 5 if n * k * d > 1e11 else 20
    kernel = median_ms(torch, lambda: nc.min_dist_argmin(X, C, x_norm, c_norm), reps)
    plain = median_ms(torch, lambda: nc.min_dist_argmin_plain(X, C, x_norm, c_norm), reps)
    library = median_ms(
        torch, lambda: torch.min(x_norm[:, None] - 2.0 * (X @ C.T) + c_norm[None, :], dim=1), reps
    )
    bound, bound_by = bound_ms(n, d, k, 4)
    del X, C
    torch.cuda.empty_cache()
    return {
        "n": n, "d": d, "k": k, "misaligned": misaligned, "copy_bytes": copy,
        "exact_mismatches": exact_mismatch,
        "mismatches": int(differ.sum()),
        "near_tie_rows": int(ties.sum()),
        "max_abs_err": err,
        "kernel_ms": kernel, "plain_ms": plain, "library_ms": library,
        "bound_ms": bound, "bound_by": bound_by,
        "tflops": 2.0 * n * k * d / kernel / 1e9,
    }


def stream_rows(total, cols, streams_seed, workers, fill_chunk, part=None):
    """(hi - lo, cols) float32 rows [lo, hi) (part; default all `total`) of a
    dataset split into `workers` seeded streams over np.linspace bounds,
    each filled by its own thread in 16,384-row chunks:
    fill_chunk(rng, out, a, b) fills global rows [a, b) into out.  A part
    regenerates only the streams that overlap it, every chunk at its full
    shape, so its rows are bit for bit those of the whole dataset (the
    path_fit_ranks workers each make their own rows this way)."""
    lo, hi = part if part is not None else (0, total)
    X = np.empty((hi - lo, cols), np.float32)
    streams = np.random.SeedSequence(streams_seed).spawn(workers)
    bounds = np.linspace(0, total, workers + 1, dtype=int)

    def fill(i):
        if bounds[i] >= hi or bounds[i + 1] <= lo:
            return
        rng_i = np.random.default_rng(streams[i])
        for a in range(bounds[i], min(bounds[i + 1], hi), 16384):
            b = min(a + 16384, bounds[i + 1])
            if lo <= a and b <= hi:
                fill_chunk(rng_i, X[a - lo : b - lo], a, b)
                continue
            chunk = np.empty((b - a, cols), np.float32)
            fill_chunk(rng_i, chunk, a, b)
            s0, s1 = max(a, lo), min(b, hi)
            if s0 < s1:
                X[s0 - lo : s1 - lo] = chunk[s0 - a : s1 - a]

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(workers)))
    return X


def blobs(rows, cols, k, seed, workers=8, labels=False, part=None):
    """Gaussian blobs (cluster_std 1, centers uniform in [-10, 10]) as in the
    benchmark's BlobsDataGen, filled by `workers` threads with independent
    seeded streams; with labels, also each row's blob.  `part` (lo, hi)
    makes only those rows (stream_rows)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(k, cols)).astype(np.float32)
    assign = rng.integers(0, k, size=rows)

    def fill_chunk(rng_i, out, a, b):
        rng_i.standard_normal(out=out, dtype=np.float32)
        out += centers[assign[a:b]]

    X = stream_rows(rows, cols, seed, workers, fill_chunk, part)
    lo, hi = part if part is not None else (0, rows)
    return (X, assign[lo:hi]) if labels else X


def run_path(torch, port, nc, wrappers, X, gen_s, keep=None):
    """The flagship configuration through the public API on the rows X (made
    in gen_s seconds).  Returns the path's record; raises on any failed
    check."""
    df = port.DataFrame.from_numpy(X, num_partitions=PARTITIONS)
    model_dir = os.path.join(REPO, "build", "chip_smoke_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED).fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = nc.min_dist_argmin.launches
    t0 = time.perf_counter()
    labels = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
    transform_s = time.perf_counter() - t0
    launches_transform = nc.min_dist_argmin.launches - launches_fit
    model.save(model_dir)
    loaded = port.load(model_dir)
    t0 = time.perf_counter()
    labels_loaded = np.concatenate([p["prediction"] for p in loaded.transform(df).partitions])
    transform2_s = time.perf_counter() - t0
    launches = nc.min_dist_argmin.launches
    launches_all = read_launches(wrappers)
    peak_bytes = torch.cuda.max_memory_allocated()

    check(launches_transform > 0, "transform did not launch the min_dist_argmin kernel")
    check(model.n_iter_ <= MAX_ITER and math.isfinite(model.inertia_),
          f"n_iter {model.n_iter_}, inertia {model.inertia_}")
    check(labels.shape == (ROWS,) and labels.dtype == np.int32
          and int(labels.min()) >= 0 and int(labels.max()) < K, "labels out of range")
    check(np.array_equal(labels, labels_loaded), "reloaded model gives other labels")

    # the kernel's labels against the plain version on the card
    centers = torch.as_tensor(model.cluster_centers_.astype(np.float32)).cuda()
    c_norm = (centers * centers).sum(dim=1)
    mismatches = near_tie_rows = tie_mismatches = 0
    upload_s = 0.0  # the host-to-device copy that transform makes per partition
    for part, lo in zip(df.partitions, np.cumsum([0] + [len(p) for p in df.partitions])):
        t0 = time.perf_counter()
        Xp = torch.from_numpy(part["features"]).cuda()
        torch.cuda.synchronize()
        upload_s += time.perf_counter() - t0
        best, parg, second = plain_top2(torch, Xp, centers, nc.squared_norms(Xp), c_norm)
        differ = torch.from_numpy(labels[lo : lo + len(part)]).cuda().long() != parg
        ties = near_ties(best, second)
        mismatches += int(differ.sum())
        near_tie_rows += int(ties.sum())
        tie_mismatches += int((differ & ties).sum())
        del Xp
    check(mismatches == tie_mismatches,
          f"{mismatches - tie_mismatches} labels differ from the plain version off near-ties")
    if keep is not None:
        keep["path"] = model
    return {
        "phase": "path",
        "rows": ROWS, "cols": COLS, "k": K, "max_iter": MAX_ITER,
        "init_mode": "random", "partitions": PARTITIONS, "rows_cut": False,
        "data_gen_s": gen_s,
        "fit_s": fit_s, "n_iter": model.n_iter_, "inertia": model.inertia_,
        "transform_s": transform_s, "transform_rows_per_s": ROWS / transform_s,
        "reloaded_transform_s": transform2_s,
        "host_to_device_s": upload_s,
        "host_to_device_bytes_per_s": X.nbytes / upload_s,
        "launches_fit": launches_fit,
        "launches_per_transform": launches_transform,
        "launches": launches,
        "launches_all": launches_all,
        "label_mismatches_vs_plain": mismatches,
        "near_tie_rows": near_tie_rows,
        "max_memory_allocated_bytes": peak_bytes,
    }


# ---------------------------------------------------------------------------
# RandomForest: kernels B2-B4 and the two flagship configurations
# ---------------------------------------------------------------------------

# The reference benchmark's RandomForest configurations (run_benchmark.sh
# 101-122): 1M x 3000 float32, 2 classes, make_classification semantics
# (10 informative, 2 redundant, class_sep 1); 100k more rows held out.
RF_ROWS, RF_HOLDOUT, RF_PARTITIONS = 1_000_000, 100_000, 8
RF_CLF = dict(numTrees=50, maxDepth=13, maxBins=128, featureSubsetStrategy="sqrt", seed=1)
RF_REG = dict(numTrees=30, maxDepth=6, maxBins=128, featureSubsetStrategy="onethird", seed=1)
N_INF, N_RED = 10, 2
RF_N_PAD = -(-RF_ROWS // 2048) * 2048  # rows padded to the histogram row tile
RF_FEATURES = 54                        # sqrt(3000): the classifier's feature subset
RF_F_PAD = 64                           # ... padded to 32s
# float stats (regression w*y): the kernel and the plain version add the
# same bf16-rounded terms in fp32, in other orders
HIST_FLOAT_RTOL, HIST_FLOAT_ATOL = 1e-4, 1e-3
# B3's index_add_ yardstick builds one index of every term up to this many
# (feature, row, tree, stat) terms, else one per chunk of rows of this many
HIST_LIBRARY_FULL = 1 << 30
# B3's shapes: the regressor's feature subset (onethird of 3000 = 1000,
# padded to 32s), the paths' (F_pad, parameters), the timing repeats, and
# ragged shapes (rows not a multiple of 16, bins not of 16, odd n-tiles,
# features not filling a block)
RF_F_PAD_REG = 1024
RF_HIST_PATHS = {"clf": (RF_F_PAD, RF_CLF), "reg": (RF_F_PAD_REG, RF_REG)}
HIST_REPS = {"clf": 5, "reg": 3}
HIST_RAGGED = [(7, 3001, 3, 4, 2, 16), (5, 1000, 2, 3, 2, 100), (3, 77, 1, 1, 1, 7), (64, 40960, 5, 1, 2, 128)]


def classification_data(rows, cols, seed, workers=8, part=None):
    """make_classification semantics as in the benchmark's
    ClassificationDataGen: hypercube-vertex centroids (class_sep 1), a random
    rotation of the informative columns, redundant linear combinations, the
    rest Gaussian noise; filled by `workers` threads with independent seeded
    streams.  Returns (X float32, y float64 in {0, 1}); `part` (lo, hi)
    makes only those rows (stream_rows)."""
    crng = np.random.default_rng(seed)
    centroids = crng.choice([-1.0, 1.0], size=(2, N_INF))
    rotate = crng.standard_normal((N_INF, N_INF))
    redundant = crng.standard_normal((N_INF, N_RED))
    y = np.random.default_rng(seed + 1).integers(0, 2, size=rows)

    def fill_chunk(rng_i, out, a, b):
        rng_i.standard_normal(out=out, dtype=np.float32)
        inf = (centroids[y[a:b]] + out[:, :N_INF]) @ rotate
        out[:, :N_INF] = inf
        out[:, N_INF : N_INF + N_RED] = inf @ redundant

    X = stream_rows(rows, cols, seed, workers, fill_chunk, part)
    lo, hi = part if part is not None else (0, rows)
    return X, y[lo:hi].astype(np.float64)


def regression_target(X, seed):
    """y = X . coef + 0.1 noise, coef with 10 informative entries in
    [0, 100) (the benchmark's RegressionDataGen)."""
    crng = np.random.default_rng(seed)
    coef = 100.0 * crng.uniform(size=N_INF)
    noise = np.random.default_rng(seed + 1).standard_normal(X.shape[0])
    return X[:, :N_INF].astype(np.float64) @ coef + 0.1 * noise


def reset_launches(wrappers):
    for fn in wrappers.values():
        fn.launches = 0


def read_launches(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def timings(torch, kernel, plain, library, reps):
    return {
        "kernel_ms": median_ms(torch, kernel, reps),
        "plain_ms": median_ms(torch, plain, max(1, reps // 2)),
        "library_ms": None if library is None else median_ms(torch, library, max(1, reps // 2)),
    }


def bound(nbytes, ops):
    """Least time for `nbytes` moved and `ops` fp32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_binning(torch, binning, X, edges, n_pad, reps, library=True):
    """B2 on one input: exact agreement with the plain version (and with
    torch.searchsorted, the library yardstick), then timings."""
    n, d = X.shape
    got = binning.bin_features_fm(X, edges, n_pad)
    want = binning.bin_features_fm_plain(X, edges, n_pad)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    check(mismatches == 0, f"bin_features_fm ({n}, {d}, {edges.shape[1]}): {mismatches} bins differ")
    del want
    lib = None
    if library:
        XT = X.T.contiguous()
        lib_fn = lambda: torch.searchsorted(edges, XT, out_int32=True)  # noqa: E731
        # searchsorted puts NaN after every edge; the kernel gives it bin 0
        lib_bins = lib_fn()
        lib_bins[torch.isnan(XT)] = 0
        check(bool((lib_bins.to(torch.int8) == got[:, :n]).all()), "bin_features_fm disagrees with searchsorted")
        del lib_bins
        lib = lib_fn
    row = timings(
        torch,
        lambda: binning.bin_features_fm(X, edges, n_pad),
        lambda: binning.bin_features_fm_plain(X, edges, n_pad),
        lib,
        reps,
    )
    if library:
        del XT
    # X read once, the bins written once; ~log2(E+1) compares per value
    b, by = bound(4.0 * n * d + 4.0 * edges.numel() + d * n_pad, n * d * math.ceil(math.log2(edges.shape[1] + 1)))
    torch.cuda.empty_cache()
    return {"n": n, "d": d, "edges": edges.shape[1], "n_pad": n_pad, "mismatches": mismatches,
            "max_abs_err": 0.0, **row, "bound_ms": b, "bound_by": by}


def hist_case(torch, dev, gen, f_pad, n, t_pack, nodes, s_dim, n_bins, integer, stray=False, features=None):
    """Random inputs at one histogram shape: bins in [0, n_bins), node ids in
    [0, nodes] (== nodes is masked), stats Poisson(1) counts x one-hot
    classes (integer) or uniform [0, 1) (float); stray: 5% of the node ids
    1 << 18 (the deep phase's pad rows) and 2% of the bins -1; features:
    the bin rows past it 0, as the fit's zero-padded feature subsets."""
    bins = torch.randint(0, n_bins, (f_pad, n), generator=gen, device=dev, dtype=torch.int8)
    if features is not None:
        bins[features:] = 0
    node = torch.randint(0, nodes + 1, (t_pack, n), generator=gen, device=dev, dtype=torch.int32)
    if stray:
        node[torch.rand((t_pack, n), generator=gen, device=dev) < 0.05] = 1 << 18
        bins[torch.rand((f_pad, n), generator=gen, device=dev) < 0.02] = -1
    if integer:
        counts = torch.poisson(torch.ones((t_pack, n), device=dev), generator=gen)
        y = torch.randint(0, s_dim, (n,), generator=gen, device=dev)
        onehot = (y[None, :] == torch.arange(s_dim, device=dev)[:, None]).float()
        stats = (counts[:, None, :] * onehot[None]).reshape(t_pack * s_dim, n)
    else:
        stats = torch.rand((t_pack * s_dim, n), generator=gen, device=dev)
    return bins, node, stats.contiguous()


def hist_terms(torch, node, stats, t_pack, nodes, s_dim, f_pad):
    """Adds the data needs: (row, feature, tree, stat) with a node in range
    and a non-zero stat."""
    valid = ((node >= 0) & (node < nodes)).repeat_interleave(s_dim, dim=0)
    return int((valid & (stats != 0)).sum()) * f_pad


def hist_flat_index(torch, dev, bins, node, stats, rows, nodes, s_dim, n_bins, f_pad, out_shape, bucketed, sl):
    """The index_add_ yardstick's (flat output index, bf16-rounded value) of
    every non-zero term of the rows in `sl`."""
    n = bins.shape[1]
    feat = torch.arange(f_pad, device=dev)[:, None]
    b = bins[:, sl].long()
    width = b.shape[1]
    if bucketed:
        bucket = (torch.arange(n, device=dev) // (n // out_shape[0]))[sl]
    idx_parts, val_parts = [], []
    for t in range(rows):
        c = node[t, sl].long()
        ok = (c >= 0) & (c < nodes)
        for s in range(s_dim):
            slot = (t * nodes + c.clamp(0, nodes - 1)) * s_dim + s
            if bucketed:
                flat = ((bucket[None, :] * f_pad + feat) * out_shape[2] + slot[None, :]) * n_bins + b
            else:
                flat = (feat * 128 + slot[None, :]) * n_bins + b
            v = stats[t * s_dim + s, sl].to(torch.bfloat16).float()
            keep = (ok & (v != 0))[None, :] & (b >= 0) & (b < n_bins)
            idx_parts.append(flat[keep])
            val_parts.append(v[None, :].expand(f_pad, width)[keep])
    return torch.cat(idx_parts), torch.cat(val_parts)


def poison(torch, shape, dev):
    """Leave a freed block of NaNs of `shape` in the caching allocator, so a
    torch.empty of that shape that follows likely gets it: a kernel that
    skips a cell of its output then shows."""
    t = torch.full(shape, float("nan"), device=dev)
    del t


def rows_first_geometry(fh):
    """The atomic kernel's geometry with rows cut before features, for
    comparison with ops/forest_hist._atomic_geometry: as many features a
    block as fit its shared memory, the rows split across blocks until the
    card is full."""
    def geometry(f_pad, n_buckets, seg_len, slots, n_bins):
        fb = max(1, min(f_pad, fh.ATOMIC_SMEM_BUDGET // (4 * slots * n_bins)))
        per_split = -(-f_pad // fb) * n_buckets
        splits = max(1, min(-(-fh.ATOMIC_TARGET_BLOCKS // per_split), -(-seg_len // fh.ATOMIC_MIN_ROWS)))
        rows = -(-seg_len // (4 * splits)) * 4
        return fb, -(-seg_len // rows), rows
    return geometry


def check_hist_bucketed(torch, fh, dev, gen, f_pad, n, n_buckets, nodes, s_dim, n_bins, reps, compare=False,
                        features=None):
    """B4 (node_histograms_bucketed) at one shape, on a poisoned output
    block: exact on integer stats, through fp32 cells and through the int32
    cells of a caller that declares them integers, HIST_FLOAT_* on float
    stats; timings on the integer inputs, declared (the classifier's main
    path) and not (compare: also under rows_first_geometry, checked
    equal)."""
    name = "node_histograms_bucketed"

    def kernel(b, c, s, integer_stats=False):
        return fh.node_histograms_bucketed(b, c, s, n_buckets, nodes, s_dim, n_bins, integer_stats=integer_stats)

    plain = lambda b, c, s: fh.node_histograms_bucketed_plain(b, c, s, n_buckets, nodes, s_dim, n_bins)  # noqa: E731
    fb, splits, rows = fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)
    out_shape = (n_buckets, f_pad, fh.slots_pad_of(nodes, s_dim), n_bins)
    errs = {}
    for integer in (False, True):
        bins, node, stats = hist_case(torch, dev, gen, f_pad, n, 1, nodes, s_dim, n_bins, integer, stray=True,
                                      features=features)
        want = plain(bins, node, stats)
        for declared in (False, True) if integer else (False,):
            poison(torch, out_shape, dev)
            got = kernel(bins, node, stats, integer_stats=declared)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if integer:
                check(err == 0.0, f"{name} integer stats (declared: {declared}): max abs err {err}")
            else:
                check(bool(torch.allclose(got, want, rtol=HIST_FLOAT_RTOL, atol=HIST_FLOAT_ATOL)),
                      f"{name} float stats: max abs err {err}")
            errs["integer" if integer else "float"] = err
            del got
        del want
    # the library yardstick: index_add_ of the bf16-rounded stats over the
    # flat output index, built beforehand
    numel = math.prod(out_shape)
    idx, vals = hist_flat_index(torch, dev, bins, node, stats, 1, nodes, s_dim, n_bins, f_pad, out_shape, True,
                                slice(0, n))
    lib = lambda: torch.zeros(numel, device=dev).index_add_(0, idx, vals)  # noqa: E731
    check(bool((lib().reshape(out_shape) == kernel(bins, node, stats)).all()), f"{name} disagrees with index_add_")
    row = timings(torch, lambda: kernel(bins, node, stats, integer_stats=True), lambda: plain(bins, node, stats),
                  lib, reps)
    row["fp32_cells_kernel_ms"] = median_ms(torch, lambda: kernel(bins, node, stats), reps)
    if compare:
        real = fh._atomic_geometry
        fh._atomic_geometry = rows_first_geometry(fh)
        try:
            row["rows_first_geometry"] = fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)
            check(bool(torch.equal(kernel(bins, node, stats, integer_stats=True), lib().reshape(out_shape))),
                  f"{name} under the rows-first geometry differs")
            row["rows_first_kernel_ms"] = median_ms(torch, lambda: kernel(bins, node, stats, integer_stats=True),
                                                    reps)
        finally:
            fh._atomic_geometry = real
    b, by = bound(bins.numel() + 4 * node.numel() + 4 * stats.numel() + 4 * numel,
                  hist_terms(torch, node, stats, 1, nodes, s_dim, f_pad))
    del bins, node, stats, lib, idx, vals
    torch.cuda.empty_cache()
    return {"kernel": name, "f_pad": f_pad, "n": n, "t_pack_or_buckets": n_buckets, "nodes": nodes,
            "s_dim": s_dim, "n_bins": n_bins, "features": features, "fb": fb, "splits": splits, "rows_per_block": rows,
            "owner_flush": splits == 1, "max_abs_err": errs["float"], "max_abs_err_integer": errs["integer"],
            **row, "bound_ms": b, "bound_by": by}


def check_forest_kernels(torch, port, binning, fh, _build, X_host, dev):
    """Phase kernels_forest: B2, B3 (both routes) and B4 against their plain
    versions on the card, at the shapes the RandomForest path gives them."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"phase": "kernels_forest", "hist_float_rtol": HIST_FLOAT_RTOL, "hist_float_atol": HIST_FLOAT_ATOL}
    # B2 at the path's shape: the classifier's rows and its 127 edges
    X = torch.from_numpy(X_host[:RF_ROWS]).to(dev)
    step = -(-RF_ROWS // 2796)
    edges = torch.from_numpy(port.ops.forest.compute_bin_edges(X_host[:RF_ROWS:step], 128)).to(dev)
    binning_rows = [check_binning(torch, binning, X, edges, RF_N_PAD, reps=5)]
    del X
    torch.cuda.empty_cache()
    # ragged, degenerate, NaN / +-inf / values equal to an edge, trailing
    # NaN edges, an n_pad that is not a multiple of 4 (byte stores), and
    # unaligned rows with a ragged strip (d 3001) at 100,000 rows
    for n, d, e, n_pad, nan_edges in ((300, 70, 31, 2048, False), (129, 1, 1, 2048, False),
                                      (2000, 5, 127, 2048, False), (2000, 9, 127, 2048, True),
                                      (301, 40, 31, 303, False), (100_000, 3001, 127, 100_352, False)):
        Xs = torch.randn((n, d), generator=gen, device=dev)
        es = torch.sort(torch.randn((d, e), generator=gen, device=dev), dim=1).values
        if e == 127 and n <= 2000:
            Xs[0], Xs[1], Xs[2] = float("nan"), float("inf"), float("-inf")
            Xs[3], Xs[4] = es[:, 0], es[:, -1]
            es[0, 60:70] = es[0, 60]  # repeated edges
        if nan_edges:  # features with 1, 27, 126 and all 127 edges NaN at the end
            for f, k in ((1, 1), (2, 27), (3, 127), (4, 126)):
                es[f, e - k:] = float("nan")
            Xs[5, :] = es[:, 0]
        row = check_binning(torch, binning, Xs, es.contiguous(), n_pad, reps=5, library=n > 2000)
        binning_rows.append({**row, "nan_edges": nan_edges})
        del Xs, es
    torch.cuda.empty_cache()
    out["bin_features_fm"] = binning_rows
    out["bin_build"] = ptxas_record(_build, "bin_features_fm", ("bin_features_fm_kernel",))
    # B3, both routes, at ragged shapes and at the first launch of every
    # shallow split level of the two flagship fits
    out["node_histograms_ragged"] = [check_hist_routes(torch, fh, dev, gen, None, None, *shape, reps=0)
                                     for shape in HIST_RAGGED]
    levels = []
    for path, (f_pad, params) in RF_HIST_PATHS.items():
        launches = port.ops.forest_grow.shallow_launches(params["numTrees"], 2, params["maxDepth"])
        for level in sorted({lv for lv, _, _ in launches}):
            nodes, t_pack = next((nd, tp) for lv, nd, tp in launches if lv == level)
            timed = path == "clf" or level == 0
            row = check_hist_routes(torch, fh, dev, gen, path, level, f_pad, RF_N_PAD, t_pack, nodes, 2, 128,
                                    reps=HIST_REPS[path], library=timed, plain_timed=timed)
            row["launches_at_level"] = sum(1 for lv, _, _ in launches if lv == level)
            levels.append(row)
            emit({"phase": "kernels_forest_level", **row})
    out["node_histograms_levels"] = levels
    # B4 at one deep window (128 buckets of 8192 rows at level 12: 32 local
    # nodes; each block owns its output slice), where the buckets are too
    # few to fill the card (2 buckets of 16,384 rows: rows split across
    # blocks, atomic flush) with 5 x 3 slots padded to 16, at the same
    # window's level 7 (1 local node), and at level 12 with the fit's 54
    # features and 10 zero-padded bin rows
    out["node_histograms_bucketed"] = [
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 32, 2, 128, reps=10),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 2 * 16384, 2, 5, 3, 128, reps=10),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 1, 2, 128, reps=10, compare=True),
        check_hist_bucketed(torch, fh, dev, gen, RF_F_PAD, 128 * 8192, 128, 32, 2, 128, reps=10,
                            features=RF_FEATURES),
    ]
    check(out["node_histograms_bucketed"][0]["owner_flush"] and not out["node_histograms_bucketed"][1]["owner_flush"],
          "the B4 cases miss one of the two flushes")
    return out


def check_hist_routes(torch, fh, dev, gen, path, level, f_pad, n, t_pack, nodes, s_dim, n_bins, reps,
                      library=False, plain_timed=False):
    """B3 at one shape through both routes: each equal to the plain version
    bit for bit on integer stats and within HIST_FLOAT_* on float stats, the
    tensor-core route bit for bit across two calls on float stats, the
    atomic route also through the int32 cells of declared integer stats;
    timings of both routes (reps > 0; the atomic one declared and not), of
    the plain version and of the index_add_ yardstick (where asked), on the
    integer inputs."""
    routes = {"mma": fh.node_histograms_mma, "atomic": fh.node_histograms_atomic}
    args = (t_pack, nodes, s_dim, n_bins)
    row = {"path": path, "level": level, "f_pad": f_pad, "n": n, "t_pack": t_pack, "nodes": nodes,
           "s_dim": s_dim, "n_bins": n_bins,
           # the classifier declares its stats integers, the regressor's are not
           "route": fh._hist_route(*args, integer_stats=path == "clf")}
    for integer in (False, True):
        bins, node, stats = hist_case(torch, dev, gen, f_pad, n, t_pack, nodes, s_dim, n_bins, integer)
        want = fh.node_histograms_plain(bins, node, stats, *args)
        for name, fn in routes.items():
            poison(torch, want.shape, dev)
            got = fn(bins, node, stats, *args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            where = f"node_histograms_{name} {[f_pad, n, *args]}"
            if integer:
                check(err == 0.0, f"{where} integer stats: max abs err {err}")
                row[f"max_abs_err_integer_{name}"] = err
            else:
                check(bool(torch.allclose(got, want, rtol=HIST_FLOAT_RTOL, atol=HIST_FLOAT_ATOL)),
                      f"{where} float stats: max abs err {err}")
                row[f"max_abs_err_{name}"] = err
                if name == "mma":
                    again = fn(bins, node, stats, *args)
                    check(bool(torch.equal(got, again)), f"{where}: two calls on float stats differ")
                    row["mma_repeat_bitwise"] = True
                    del again
            del got
        if integer:
            poison(torch, want.shape, dev)
            got = fh.node_histograms_atomic(bins, node, stats, *args, integer_stats=True)
            err = float((got - want).abs().max())
            check(err == 0.0, f"node_histograms_atomic {[f_pad, n, *args]} declared integer stats: max abs err {err}")
            row["max_abs_err_integer_atomic_declared"] = err
            del got
        del want
    if reps:
        for name, fn in routes.items():
            row[f"{name}_ms"] = median_ms(torch, lambda: fn(bins, node, stats, *args), reps)  # noqa: B023
        row["atomic_int_ms"] = median_ms(
            torch, lambda: fh.node_histograms_atomic(bins, node, stats, *args, integer_stats=True), reps)
        row["plain_ms"] = (median_ms(torch, lambda: fh.node_histograms_plain(bins, node, stats, *args), 1)
                           if plain_timed else None)
        row["library_ms"] = hist_library_ms(torch, fh, dev, bins, node, stats, *args) if library else None
        out_bytes = 4 * f_pad * fh.M_SLOTS * n_bins
        row["bound_ms"], row["bound_by"] = bound(
            bins.numel() + 4 * node.numel() + 4 * stats.numel() + out_bytes,
            hist_terms(torch, node, stats, t_pack, nodes, s_dim, f_pad))
        # the tensor-core route's multiply-adds at the dense bf16 peak
        macs = f_pad * n * (-(-(t_pack * nodes * s_dim) // 16) * 16) * (-(-n_bins // 16) * 16)
        row["mma_peak_ms"] = 1e3 * 2 * macs / PEAK_BF16_FLOPS
    del bins, node, stats
    torch.cuda.empty_cache()
    return row


def hist_library_ms(torch, fh, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins):
    """The index_add_ yardstick of B3: the bf16-rounded non-zero terms added
    over the flat output index, built beforehand; built and applied in row
    chunks where one index of every term would not fit the card, only the
    index_add_ calls timed.  Checked against the tensor-core route."""
    f_pad, n = bins.shape
    out_shape = (f_pad, 128, n_bins)
    numel = math.prod(out_shape)
    want = fh.node_histograms_mma(bins, node, stats, t_pack, nodes, s_dim, n_bins)
    if f_pad * n * t_pack * s_dim <= HIST_LIBRARY_FULL:
        idx, vals = hist_flat_index(torch, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins, f_pad,
                                    out_shape, False, slice(0, n))
        lib = lambda: torch.zeros(numel, device=dev).index_add_(0, idx, vals)  # noqa: E731
        check(bool((lib().reshape(out_shape) == want).all()), "node_histograms disagrees with index_add_")
        return median_ms(torch, lib, 3)
    chunk = max(2048, HIST_LIBRARY_FULL // (f_pad * t_pack * s_dim))
    lib_ms, acc = [], torch.zeros(numel, device=dev)
    for _ in range(2):
        acc.zero_()
        total = 0.0
        for lo in range(0, n, chunk):
            idx, vals = hist_flat_index(torch, dev, bins, node, stats, t_pack, nodes, s_dim, n_bins, f_pad,
                                        out_shape, False, slice(lo, min(lo + chunk, n)))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            acc.index_add_(0, idx, vals)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
            del idx, vals
        lib_ms.append(total)
    check(bool(torch.equal(acc.reshape(out_shape), want)), "node_histograms disagrees with index_add_")
    return statistics.median(lib_ms)


def run_rf_path(torch, port, wrappers, phase, est, X, y, classification, keep=None):
    """One RandomForest flagship configuration through the public API on
    the first RF_ROWS rows; held-out quality on the rest."""
    df = port.DataFrame.from_numpy(X[:RF_ROWS], y[:RF_ROWS], num_partitions=RF_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[RF_ROWS:], num_partitions=1)
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_launches(wrappers)
    # B3's launches by route: as _hist_route sends the shallow phase's launches
    params = {k.name: v for k, v in est.extractParamMap().items()}
    shapes = port.ops.forest_grow.shallow_launches(params["numTrees"], 2, params["maxDepth"])
    routes = [port.ops.forest_hist._hist_route(tp, nodes, 2, params["maxBins"], integer_stats=classification)
              for _, nodes, tp in shapes]
    hist_expected = {f"node_histograms_{r}": routes.count(r) for r in ("mma", "atomic")}
    for name, want in hist_expected.items():
        check(launches_fit[name] == want, f"the fit launched {name} {launches_fit[name]} times, not {want}")
    check(launches_fit["node_histograms_mma"] > 0, "the fit launched the tensor-core route no time")
    t0 = time.perf_counter()
    out = model.transform(df)
    transform_s = time.perf_counter() - t0
    pred = np.concatenate([p["prediction"] for p in out.partitions])
    rec = {}
    if classification:
        model.save(model_dir)
        loaded = port.load(model_dir)
        out2 = loaded.transform(df)
        check(np.array_equal(pred, np.concatenate([p["prediction"] for p in out2.partitions])),
              "reloaded forest gives other predictions")
        check(np.array_equal(np.concatenate([p["probability"] for p in out.partitions]),
                             np.concatenate([p["probability"] for p in out2.partitions])),
              "reloaded forest gives other probabilities")
        rec["reloaded_identical"] = True
    launches = read_launches(wrappers)
    peak_bytes = torch.cuda.max_memory_allocated()
    with deep_launch_shapes(port) as deep:
        rec["profile"] = profile_run(torch, lambda: est.fit(df), PROFILE_RANGES, wrappers)
    if deep:
        rec["deep_launches"] = deep
    hold_pred = np.concatenate([p["prediction"] for p in model.transform(hold).partitions])
    y_hold = y[RF_ROWS:]
    check(np.isfinite(pred).all() and np.isfinite(hold_pred).all(), "non-finite predictions")
    if classification:
        acc = float((hold_pred == y_hold).mean())
        majority = float(max(y_hold.mean(), 1 - y_hold.mean()))
        for name in ("bin_features_fm", "node_histograms_bucketed"):
            check(launches_fit[name] > 0, f"the fit launched {name} no time")
        check(acc > majority, f"held-out accuracy {acc} <= majority share {majority}")
        rec.update(holdout_accuracy=acc, majority_share=majority)
    else:
        r2 = float(1.0 - ((hold_pred - y_hold) ** 2).mean() / y_hold.var())
        check(r2 > 0.0, f"held-out R^2 {r2} <= 0")
        rec["holdout_r2"] = r2
    if keep is not None:
        keep[phase] = model
    return {
        "phase": phase, "rows": RF_ROWS, "cols": X.shape[1], "holdout_rows": len(y_hold),
        "params": {k.name: v for k, v in est.extractParamMap().items() if k.name in RF_CLF},
        "fit_s": fit_s, "transform_s": transform_s, "transform_rows_per_s": RF_ROWS / transform_s,
        "launches_fit": launches_fit, "launches": launches, "hist_launches_expected": hist_expected,
        "max_memory_allocated_bytes": peak_bytes, **rec,
    }


class deep_launch_shapes:
    """Within the block, the B4 launches of the deep phase by local node
    count: launches, rows, and launches whose rows the atomic kernel splits
    across blocks (ops/forest_hist._atomic_geometry), as a list of records
    (empty if the fit has no deep phase).  Every call goes on to the
    wrapper unchanged."""

    def __init__(self, port):
        self.grow, self.fh, self.rows = port.ops.forest_grow, port.ops.forest_hist, {}

    def __enter__(self):
        self.real = self.grow.node_histograms_bucketed

        def record(bins_sub, node_rel, stats_s, n_buckets, nodes, s_dim, n_bins, **kw):
            f_pad, n = bins_sub.shape
            splits = self.fh._atomic_geometry(f_pad, n_buckets, n // n_buckets, nodes * s_dim, n_bins)[1]
            r = self.rows.setdefault(nodes, {"nodes": nodes, "launches": 0, "rows": 0, "split_launches": 0})
            r["launches"] += 1
            r["rows"] += n
            r["split_launches"] += splits > 1
            return self.real(bins_sub, node_rel, stats_s, n_buckets=n_buckets, nodes=nodes, s_dim=s_dim,
                             n_bins=n_bins, **kw)

        self.grow.node_histograms_bucketed = record
        self.out = []
        return self.out

    def __exit__(self, *exc):
        self.grow.node_histograms_bucketed = self.real
        self.out.extend(self.rows[k] for k in sorted(self.rows))
        return False


PROFILE_RANGES = ("core.ingest", "forest.bin", "forest.shallow", "forest.deep_layout", "forest.deep")
# the port's kernels as the trace names them (all in anonymous namespaces)
PORT_KERNEL_SYMBOLS = ("min_dist_argmin_kernel", "min_dist_tile_kernel", "bin_features_fm_kernel", "hist_kernel",
                       "hist_mma_kernel", "knn_topm_tile_kernel", "knn_count_tile_kernel", "radix_merge_kernel",
                       "window_merge_kernel", "probed_lut_kernel", "fastscan_probed_kernel", "ring_shift_kernel")
# launched beside hist_mma_kernel by the same wrapper call (the masked-stat
# operand, the split sum): timed with the port's kernels, not counted
PORT_AUX_SYMBOLS = ("hist_mask_stats_kernel", "hist_split_sum_kernel")


def port_kernel(name):
    """The port's kernel symbol a trace event names, or None."""
    if "at::" in name:
        return None
    return next((s for s in PORT_KERNEL_SYMBOLS + PORT_AUX_SYMBOLS if f"(anonymous namespace)::{s}" in name), None)


def profile_run(torch, run, ranges, wrappers):
    """One more call of `run` under torch.profiler: the host milliseconds
    inside each of the port's `ranges`, the device's busy milliseconds (the
    union of the intervals of every kernel and copy on the card), the
    device's idle share of the call's wall time, and the device time of the
    kernels that took the most.  The trace is complete when it holds one
    event for each launch the port's wrappers counted during the call (a
    trace of the kNN path once lost one of two 0.7-s kernels, halving the
    busy time); the busy time and idle share of an incomplete trace are
    null, not measured.  The profiler slows the call; the path's own timings
    come from the calls before it."""
    before = sum(read_launches(wrappers).values())
    rec = profile_once(torch, run, ranges)
    rec["launches"] = sum(read_launches(wrappers).values()) - before
    rec["trace_complete"] = rec["traced_launches"] == rec["launches"]
    if not rec["trace_complete"]:
        rec["device_busy_ms"] = rec["device_idle_share"] = None
    return rec


def profile_once(torch, run, ranges):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)  # not the profiler's own start and stop
    events = prof.events()
    host = {k: 0.0 for k in ranges}
    spans, per_kernel, traced, port_ms, port_n, copy_us = [], {}, 0, {}, {}, 0.0
    for e in events:
        if e.device_type == DeviceType.CPU:
            if e.name in host:
                host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name not in host and not e.name.startswith("Activity Buffer"):
            # a kernel or a copy on the card (not a range's device-side
            # annotation, nor the profiler's own buffer requests)
            spans.append((e.time_range.start, e.time_range.end))
            if e.name.startswith(("Memcpy", "Memset")):
                copy_us += e.time_range.end - e.time_range.start
            symbol = port_kernel(e.name)
            if symbol is not None:
                traced += symbol not in PORT_AUX_SYMBOLS
                port_ms[symbol] = port_ms.get(symbol, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
                port_n[symbol] = port_n.get(symbol, 0) + 1
            ms, count = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "profiled_ms": wall_ms,
        "range_host_ms": host,
        "device_busy_ms": busy_us / 1e3,
        "device_copy_ms": copy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "top_device_ms": [[name[:90], ms, count] for name, (ms, count) in top],
        "port_kernel_ms": port_ms,
        "port_launches": port_n,
        "traced_launches": traced,
    }


def forest_card_vs_cpu(torch, port):
    """The same reduced fit (bootstrap off) on the card and under
    use_device("cpu"): the trees must be identical, which holds the whole
    tree growth on the card against the kernels' plain versions."""
    X, y = classification_data(65536, 256, SEED + 7)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    est = port.RandomForestClassifier(numTrees=4, maxDepth=13, maxBins=128, featureSubsetStrategy="sqrt",
                                      bootstrap=False, seed=1)
    t0 = time.perf_counter()
    card = est.fit(df)
    card_s = time.perf_counter() - t0
    with port.device.use_device("cpu"):
        t0 = time.perf_counter()
        cpu = est.fit(df)
        cpu_s = time.perf_counter() - t0
    for name in ("features_", "thresholds_", "node_counts_"):
        a, b = getattr(card, name), getattr(cpu, name)
        check(np.array_equal(a, b), f"card and CPU trees differ in {name} at {int((a != b).sum())} nodes")
    return {"phase": "forest_card_vs_cpu", "rows": 65536, "cols": 256, "trees": 4, "max_depth": 13,
            "split_nodes": int((card.features_ >= 0).sum()), "identical": True,
            "card_fit_s": card_s, "cpu_fit_s": cpu_s}


# ---------------------------------------------------------------------------
# Exact kNN: kernels B5-B8 and the JAX package's kNN arm
# ---------------------------------------------------------------------------

# The JAX package's kNN arm (bench.py:303-339, k from
# benchmark/bench_nearest_neighbors.py:21): 400,000 x 3000 float32 items,
# standard normal from seed 0; 16,384 queries from seed 7; k = 200; 8 item
# and 2 query partitions.  Not cut.
KNN_ITEMS, KNN_QUERIES, KNN_K = 400_000, 16_384, 200
KNN_ITEM_PARTS, KNN_QUERY_PARTS, KNN_ITEM_SEED, KNN_QUERY_SEED = 8, 2, 0, 7
KNN_BLOCK = 8192       # queries per block (knn_search_prepared's default)
KNN_SAMPLE = 1024      # queries held against float64 brute force
KNN_JOIN_QUERIES = 1000
# distances against float64 (fp32 sums of 3000 products; ~1e-7 relative
# expected); index sets may differ only in items within KNN_TIE_RTOL of the
# k-th distance
KNN_DIST_RTOL, KNN_TIE_RTOL = 1e-4, 1e-5
# ragged kernel shapes (n, d, Q, m, k, invalid trailing items, misaligned):
# n not a multiple of 1024 nor of the 128-item tile, d not a multiple of the
# 8-feature slice, Q not a multiple of the 128-query tile, k past the valid
# items or past the pool; a pool of 3,418 groups x 5 = 17,090 candidates a
# query, 65,537 groups, B5's and B8's 4-byte copies (d % 4 != 0) on 1,563 x
# 5 item and query tiles; the last three on misaligned views of the items
# and queries (each one float past a 16-byte boundary: 4-byte copies at
# d % 4 == 0) and at m = 32, groups ending 1, 129 and 1023 items in
KNN_RAGGED = [
    (2100, 300, 250, 5, 10, 30, False),
    (700, 37, 33, 32, 40, 0, False),
    (20, 5, 7, 32, 25, 0, False),
    (3000, 515, 384, 20, 33, 0, False),
    (1076, 37, 33, 32, 40, 36, False),
    (3_500_000, 32, 64, 5, 200, 0, False),
    (67_109_000, 3, 33, 2, 5, 0, False),
    (200_003, 515, 517, 9, 200, 3, False),
    (1025, 256, 300, 9, 50, 0, True),
    (9345, 3000, 130, 32, 200, 17, True),
    (50_175, 64, 1000, 32, 100, 0, True),
]
# B5 at the main path's other shapes, exact on integer data and timed on
# Gaussian data, (n, Q, m): one shard of path_knn_mesh, and the pool's
# widest m at the flagship's items
KNN_POOL_SHAPES = [(KNN_ITEMS // 4, KNN_BLOCK, 15), (KNN_ITEMS, KNN_BLOCK, 32)]
# B7 alone on wide tied pools: (Q, ng, m) and the k of each merge, one
# 4,096-rank window, several, all of the pool and past it
KNN_WIDE_POOL, KNN_WIDE_KS = (256, 4000, 5), (200, 9000, 20000, 25000)
# B7's routes forced on that pool at k = 200, (CTAs a row, threads a CTA):
# each the route picks for some pool width (the radix kernel on 1-16 CTAs
# a row), and the windowed kernel (0)
MERGE_CONFIGS = ((1, 256), (2, 512), (4, 512), (8, 512), (16, 512), (0, 256))
# knn_streamed: the item budget (bytes), so 400,000 x 3000 items make 3
# blocks, and its queries
KNN_STREAM_BUDGET, KNN_STREAM_QUERIES = 2_000_000_000, 2048
KNN_PROFILE_RANGES = ("knn.dispatch", "knn.collect", "knn.fallback")


def normal_data(rows, cols, seed, workers=8, part=None):
    """Standard normal float32 (rows, cols), filled by `workers` threads
    with independent streams spawned from `seed`; `part` (lo, hi) makes only
    those rows (stream_rows)."""
    return stream_rows(rows, cols, seed, workers, lambda rng_i, out, a, b: rng_i.standard_normal(
        out=out, dtype=np.float32), part)


def knn_exact_case(torch, kk, nc, dev, gen, n, d, q, m, k, invalid, misaligned=False):
    """B5, B7 and B8 against their plain versions on integer-valued data
    (every sum exact in fp32): equal pools (values and positions, -inf
    slots included), equal merges, equal counts."""
    X = torch.randint(-3, 4, (n, d), generator=gen, device=dev).float()
    Q = torch.randint(-3, 4, (q, d), generator=gen, device=dev).float()
    X, Q = b1_input(torch, X, dev, misaligned), b1_input(torch, Q, dev, misaligned)
    copy = nc.copy_bytes(X, Q)
    check((copy == 4) == (misaligned or d % 4 != 0), f"kNN ({n},{d},{q}) takes {copy}-byte copies")
    norm = (X * X).sum(dim=1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    if invalid:
        valid[n - invalid :] = False
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    v, p = kk.knn_candidates(X, norm, valid, Q, m)
    pv, pp = kk.knn_candidates_plain(X, inorm, Q, qn, m)
    out = kk.knn_fused_merge(v, p, k)
    ref = kk.knn_fused_merge_plain(v, p, k)
    cnt = kk.knn_count(X, norm, valid, Q, out[3])
    pcnt = kk.knn_count_plain(X, inorm, Q, qn, out[3])
    torch.cuda.synchronize()
    ng = v.shape[1]
    neg = ~torch.isfinite(v)
    first = (torch.arange(ng, device=dev, dtype=torch.int32) * kk.GROUP)[None, :, None].expand_as(p)
    rec = {
        "n": n, "d": d, "q": q, "m": m, "k": k, "invalid": invalid, "misaligned": misaligned,
        "pool_value_mismatches": int((v.view(torch.int32) != pv.view(torch.int32)).sum()),
        "pool_position_mismatches": int((p != pp).sum()),
        "neg_inf_slots": int(neg.sum()), "neg_inf_slots_off_group_start": int((p != first)[neg].sum()),
        "merge_mismatches": [int((a != b).sum()) for a, b in zip(out, ref)],
        "count_mismatches": int((cnt != pcnt).sum()), "count_max_abs_err": int((cnt - pcnt).abs().max()),
        "copy_bytes": copy,
        "invalid_in_pool": int(((p >= n - invalid) & torch.isfinite(v)).sum()) if invalid else 0,
    }
    check(rec["pool_value_mismatches"] == 0 and rec["pool_position_mismatches"] == 0,
          f"knn_candidates ({n},{d},{q},m={m}) integer data: pool differs from the plain version: {rec}")
    check(rec["neg_inf_slots_off_group_start"] == 0, f"a -inf slot holds another position than its group's first: {rec}")
    check(sum(rec["merge_mismatches"]) == 0, f"knn_fused_merge ({n},{d},{q},k={k}) differs: {rec}")
    check(rec["count_mismatches"] == 0, f"knn_count ({n},{d},{q}) differs: {rec}")
    check(rec["invalid_in_pool"] == 0, f"an invalid item entered the pool: {rec}")
    del X, Q
    return rec


def merge_mismatches(torch, out, ref):
    """Values differing between two merges' five outputs (dist and
    thresholds compared as bits)."""
    return [int((a.view(torch.int32) != b.view(torch.int32)).sum()) if a.dtype == torch.float32
            else int((a != b).sum()) for a, b in zip(out, ref)]


def knn_wide_merge(torch, kk, dev, gen):
    """B7 against its plain version on one wide pool of tied values (a
    quarter of each row's values -inf), at every k of KNN_WIDE_KS through
    the route the wrapper takes, and at k = 200 on each configuration of
    MERGE_CONFIGS: bit for bit."""
    q, ng, m = KNN_WIDE_POOL
    v = torch.randint(-40, 0, (q, ng, m), generator=gen, device=dev).float()
    v[torch.rand(q, ng, m, generator=gen, device=dev) < 0.25] = float("-inf")
    p = torch.randint(0, 2**31 - 1, (q, ng, m), generator=gen, device=dev, dtype=torch.int32)
    mismatches, routes = {}, {}
    for k in KNN_WIDE_KS:
        out, ref = kk.knn_fused_merge(v, p, k), kk.knn_fused_merge_plain(v, p, k)
        mismatches[k] = merge_mismatches(torch, out, ref)
        routes[k] = list(kk._merge_route(ng * m, k))
        check(sum(mismatches[k]) == 0, f"knn_fused_merge on a ({q}, {ng}, {m}) pool, k={k}, differs: {mismatches[k]}")
    ref = kk.knn_fused_merge_plain(v, p, KNN_K)
    by_config = {}
    for cluster, threads in MERGE_CONFIGS:
        name = f"{cluster}x{threads}"
        by_config[name] = merge_mismatches(torch, kk._merge_cuda(v, p, KNN_K, cluster, threads), ref)
        check(sum(by_config[name]) == 0, f"B7 on {cluster} CTAs a row of {threads} threads (0: windowed) differs: "
                                         f"{by_config[name]}")
    ms = median_ms(torch, lambda: kk.knn_fused_merge(v, p, KNN_K), 5)
    return {"q": q, "ng": ng, "m": m, "pool": ng * m, "ks": list(KNN_WIDE_KS), "mismatches": mismatches,
            "routes": routes, "k200_by_config": by_config, "kernel_ms_k200": ms}


def ptxas_record(_build, library, symbols):
    """ptxas registers and spills of each kernel of `library` whose mangled
    name holds one of `symbols`, from its build log, by mangled name."""
    out, current = {}, None
    for line in _build.build_log(library).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if line.count("'") >= 2 else line
            current = name if any(sym in name for sym in symbols) else None
            if current:
                out[current] = {}
        elif current and "spill stores" in line:
            words = line.replace(",", "").split()
            out[current]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[current]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif current and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[current]["registers"] = int(words[words.index("registers") - 1])
    check(all(any(sym in name for name in out) for sym in symbols), f"the {library} build log lacks a kernel: {out}")
    return out


def merge_occupancy(_build, p, k, cluster, threads):
    """Clusters of B7's radix kernel resident on the card at once, and its
    dynamic shared memory a CTA, for one launch shape."""
    import ctypes

    fn = _build.load("knn_merge").srml_knn_merge_occupancy
    fn.argtypes = [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(p, k, cluster, threads, ctypes.byref(clusters), ctypes.byref(smem))
    check(err == 0 and clusters.value >= 1, f"B7 radix kernel (p={p}, k={k}, cluster={cluster}, threads={threads}): "
                                            f"error {err}, {clusters.value} clusters")
    return {"p": p, "k": k, "cluster": cluster, "threads": threads, "resident_clusters": clusters.value,
            "dynamic_smem_bytes": smem.value}


def merge_routes(kk, m):
    """B7's route (CTAs a row of the radix kernel, 0 = windowed) at each
    launch shape of the main path and of the checks."""
    shapes = {"flagship": (-(-KNN_ITEMS // kk.GROUP), m, KNN_K),
              "mesh": (MESH_SHARDS * -(-KNN_ITEMS // MESH_SHARDS // kk.GROUP), 15, KNN_K),
              **{f"ann_k{k}": (ANN_NPROBE, ANN_L_PAD, k) for k in ANN_MERGE_KS},
              **{f"wide_k{k}": (KNN_WIDE_POOL[1], KNN_WIDE_POOL[2], k) for k in KNN_WIDE_KS}}
    return {name: {"pool": ng * mm, "k": k, "route": list(kk._merge_route(ng * mm, k))}
            for name, (ng, mm, k) in shapes.items()}


def pool_library(torch, kk, X, Q, inorm, qn, m):
    """The pool as one PyTorch composition: matmul + a per-group topk."""
    q_n, n = Q.shape[0], X.shape[0]
    ng = -(-n // kk.GROUP)
    neg = -((qn[:, None] - 2.0 * (Q @ X.T)) + inorm[None, :])
    neg = torch.nn.functional.pad(neg, (0, ng * kk.GROUP - n), value=float("-inf"))
    return torch.topk(neg.view(q_n, ng, kk.GROUP), m, dim=2)


def merge_bound(q_n, p, k):
    """B7's least time: the bytes the function needs.  Each pool value read
    once (4 bytes a slot), the positions of the k kept only (4 bytes each),
    k distances and positions and three scalars a row written."""
    return bound(4.0 * q_n * p + 4.0 * q_n * k + 8.0 * q_n * k + 12.0 * q_n, float(q_n * p))


def pool_bound(q_n, n, d, m):
    """B5's least time: 2 * Q * n * d fp32 operations against its inputs
    read once and its (Q, ng, m) values and positions written once."""
    ng = -(-n // 1024)
    return bound(4.0 * (q_n * d + n * d + q_n + n) + 8.0 * q_n * ng * m, 2.0 * q_n * n * d)


def time_pool(torch, kk, dev, gen, n, q_n, m):
    """B5 at (Q, n, d = COLS, m) on Gaussian data: kernel, plain and library
    times and the bound."""
    X = torch.randn(n, COLS, generator=gen, device=dev)
    Q = torch.randn(q_n, COLS, generator=gen, device=dev)
    norm = (X * X).sum(dim=1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    row = timings(torch, lambda: kk.knn_candidates(X, norm, valid, Q, m),
                  lambda: kk.knn_candidates_plain(X, inorm, Q, qn, m),
                  lambda: pool_library(torch, kk, X, Q, inorm, qn, m), 3)
    row["bound_ms"], row["bound_by"] = pool_bound(q_n, n, COLS, m)
    del X, Q
    torch.cuda.empty_cache()
    return {"n": n, "d": COLS, "q": q_n, "m": m, **row}


def pool_build_record(_build):
    """ptxas registers and spills of the pool kernel's two copy widths
    (VEC 4: 16-byte copies, VEC 1: 4-byte), from its build log."""
    out, current = {}, None
    for line in _build.build_log("knn_topm").splitlines():
        if "Compiling entry function" in line:
            current = None
            if "knn_topm_tile_kernel" in line:
                current = "copy_16_bytes" if "ILi4E" in line else "copy_4_bytes"
                out[current] = {}
        elif current and "spill stores" in line:
            words = line.replace(",", "").split()
            out[current]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[current]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif current and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[current]["registers"] = int(words[words.index("registers") - 1])
    check(set(out) == {"copy_16_bytes", "copy_4_bytes"}, f"the build log lacks a pool kernel: {out}")
    return out


def pool_occupancy(_build, kk):
    """Resident pool blocks an SM and their dynamic shared memory, at every
    m the checks use, for both copy widths."""
    import ctypes

    fn = _build.load("knn_topm").srml_knn_topm_occupancy
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for m in (1, 5, 9, 15, 20, 32):
        for vec in (4, 1):
            blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
            err = fn(m, vec, ctypes.byref(blocks), ctypes.byref(smem))
            check(err == 0 and blocks.value >= 1, f"pool kernel m={m} vec={vec}: error {err}, {blocks.value} blocks")
            rows.append({"m": m, "copy_bytes": 4 * vec, "blocks_per_sm": blocks.value,
                         "dynamic_smem_bytes": smem.value})
    return rows


def check_knn_kernels(torch, kk, nc, knn_ops, _build, dev):
    """Phase kernels_knn: B5-B8 against their plain versions at ragged shapes
    (one with a pool wider than 16,384, misaligned views, m = 32), B7 on
    wide tied pools, B5 at the mesh's shard shape and at m = 32, and all at
    one flagship block, with timings at the flagship block."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m = knn_ops._scan_geometry(KNN_K, KNN_ITEMS)[1]
    build = pool_build_record(_build)
    occupancy = pool_occupancy(_build, kk)
    routes = merge_routes(kk, m)
    merge_build = ptxas_record(_build, "knn_merge", ("radix_merge_kernel", "window_merge_kernel"))
    merge_occ = [merge_occupancy(_build, r["pool"], r["k"], *r["route"]) for r in routes.values() if r["route"][0]]
    ragged = [knn_exact_case(torch, kk, nc, dev, gen, *shape) for shape in KNN_RAGGED]
    check(any(r["copy_bytes"] == 4 and r["misaligned"] and r["d"] % 4 == 0 for r in ragged)
          and any(r["copy_bytes"] == 4 and r["d"] % 4 for r in ragged)
          and any(r["copy_bytes"] == 16 for r in ragged),
          "the ragged cases miss one of B5's and B8's copy widths")
    torch.cuda.empty_cache()
    pool_shapes = []
    for n, q_n, pm in KNN_POOL_SHAPES:
        exact = knn_exact_case(torch, kk, nc, dev, gen, n, COLS, q_n, pm, KNN_K, 0)
        torch.cuda.empty_cache()
        pool_shapes.append({**time_pool(torch, kk, dev, gen, n, q_n, pm), "integer": exact})
        emit({"phase": "kernels_knn_pool", **pool_shapes[-1]})
    wide_merge = knn_wide_merge(torch, kk, dev, gen)
    flagship_int = knn_exact_case(torch, kk, nc, dev, gen, KNN_ITEMS, COLS, KNN_BLOCK, m, KNN_K, 0)
    torch.cuda.empty_cache()

    X = torch.randn(KNN_ITEMS, COLS, generator=gen, device=dev)
    Q = torch.randn(KNN_BLOCK, COLS, generator=gen, device=dev)
    norm = (X * X).sum(dim=1)
    valid = torch.ones(KNN_ITEMS, dtype=torch.bool, device=dev)
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    v, p = kk.knn_candidates(X, norm, valid, Q, m)
    pv, pp = kk.knn_candidates_plain(X, inorm, Q, qn, m)
    out = kk.knn_fused_merge(v, p, KNN_K)
    ref = kk.knn_fused_merge_plain(v, p, KNN_K)
    plain_route = kk.knn_fused_merge_plain(pv, pp, KNN_K)
    torch.cuda.synchronize()
    flagship_mismatches = merge_mismatches(torch, out, ref)
    check(sum(flagship_mismatches) == 0,
          f"knn_fused_merge differs from its plain version on one pool: {flagship_mismatches}")
    merge_err = float((out[0] - ref[0]).abs().max())
    pool_err = float((v - pv).abs().max())
    dist_err = float((out[0] - plain_route[0]).abs().max())
    check(bool(torch.allclose(out[0], plain_route[0], rtol=KNN_DIST_RTOL, atol=0.0)),
          f"kernel route distances off the plain route's by up to {dist_err}")
    rows_differ = int((out[1] != plain_route[1]).any(dim=1).sum())
    thresh, unflagged = out[3], out[2] == 0
    cnt = kk.knn_count(X, norm, valid, Q, thresh)
    torch.cuda.synchronize()
    # an unflagged row is complete: every item above its threshold is in
    # its list, and the count (bitwise the pool's d2) must say so
    check(bool((cnt == out[4])[unflagged].all()), "count kernel disagrees with the merged lists on unflagged rows")
    del pv, pp, plain_route, ref

    q_n, n, d, P = KNN_BLOCK, KNN_ITEMS, COLS, v.shape[1] * v.shape[2]
    ng = v.shape[1]

    def library_count():
        return (-((qn[:, None] - 2.0 * (Q @ X.T)) + inorm[None, :]) > thresh[:, None]).sum(dim=1)

    dot_ops = 2.0 * q_n * n * d
    in_bytes = 4.0 * (q_n * d + n * d + q_n + n)
    b5 = timings(torch, lambda: kk.knn_candidates(X, norm, valid, Q, m),
                 lambda: kk.knn_candidates_plain(X, inorm, Q, qn, m),
                 lambda: pool_library(torch, kk, X, Q, inorm, qn, m), 3)
    b5["bound_ms"], b5["bound_by"] = pool_bound(q_n, n, d, m)
    b6 = {"kernel_ms": median_ms(torch, lambda: kk.knn_candidates_audit(X, norm, valid, Q, m), 2),
          "plain_ms": b5["plain_ms"], "library_ms": b5["library_ms"],
          "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"]}
    window = kk._merge_cuda(v, p, KNN_K, 0)
    window_mismatches = merge_mismatches(torch, window, out)
    check(sum(window_mismatches) == 0, f"the windowed B7 differs from the radix one: {window_mismatches}")
    b7 = timings(torch, lambda: kk.knn_fused_merge(v, p, KNN_K), lambda: kk.knn_fused_merge_plain(v, p, KNN_K),
                 lambda: torch.topk(v.view(q_n, P), KNN_K, dim=1), 20)
    # the first design (the windowed kernel) in the same run
    b7["window_ms"] = median_ms(torch, lambda: kk._merge_cuda(v, p, KNN_K, 0), 20)
    b7["route"] = list(kk._merge_route(P, KNN_K))
    b7["bound_ms"], b7["bound_by"] = merge_bound(q_n, P, KNN_K)
    b8 = timings(torch, lambda: kk.knn_count(X, norm, valid, Q, thresh),
                 lambda: kk.knn_count_plain(X, inorm, Q, qn, thresh), library_count, 3)
    b8["bound_ms"], b8["bound_by"] = bound(in_bytes + 8.0 * q_n, dot_ops + q_n * n)
    del X, Q, v, p
    torch.cuda.empty_cache()
    shape = {"n": n, "d": d, "q": q_n, "m": m, "k": KNN_K, "ng": ng, "pool": P}
    return {
        "phase": "kernels_knn", "pool_build": build, "pool_occupancy": occupancy, "merge_routes": routes,
        "merge_build": merge_build, "merge_occupancy": merge_occ, "ragged": ragged,
        "pool_shapes": pool_shapes, "wide_merge": wide_merge, "flagship_integer": flagship_int,
        "flagship": {**shape, "pool_max_abs_err": pool_err, "dist_max_abs_err_vs_plain_route": dist_err,
                     "flagged_rows": int((~unflagged).sum()),
                     "rows_with_other_positions_vs_plain_route": rows_differ, "dist_rtol": KNN_DIST_RTOL},
        "knn_candidates": {**shape, **b5, "max_abs_err": pool_err},
        "knn_candidates_audit": {**shape, **b6, "max_abs_err": pool_err},
        "knn_fused_merge": {**shape, **b7, "max_abs_err": merge_err},
        # the count is held against its plain version where both are exact:
        # the flagship block on integer data
        "knn_count": {**shape, **b8, "max_abs_err": float(flagship_int["count_max_abs_err"])},
    }


def check_against_float64(torch, prepared, Qh, idx, dist, dev):
    """KNN_SAMPLE queries against float64 brute force over the staged items:
    distances within KNN_DIST_RTOL, and the returned set differs from the
    true top k only in items within KNN_TIE_RTOL of the k-th distance."""
    rng = np.random.default_rng(SEED)
    sample = np.sort(rng.choice(len(Qh), KNN_SAMPLE, replace=False))
    q64 = torch.from_numpy(Qh[sample]).to(dev, torch.float64)
    items, n = prepared.items, prepared.items.shape[0]
    d2 = torch.empty((KNN_SAMPLE, n), dtype=torch.float64, device=dev)
    qn = (q64 * q64).sum(dim=1)
    for lo in range(0, n, 50_000):
        x = items[lo : lo + 50_000].double()
        d2[:, lo : lo + 50_000] = (qn[:, None] - 2.0 * (q64 @ x.T)) + (x * x).sum(dim=1)[None, :]
    d64 = d2.clamp_(min=0.0).sqrt_()
    true_d = torch.topk(d64, KNN_K, dim=1, largest=False, sorted=True).values
    kth = true_d[:, -1:]
    pos_of_id = np.empty(n, np.int64)
    pos_of_id[prepared.ids] = np.arange(n)
    got_pos = torch.from_numpy(pos_of_id[idx[sample]]).to(dev)
    got_d = torch.from_numpy(dist[sample]).to(dev, torch.float64)
    got_d64 = d64.gather(1, got_pos)
    dist_err = float(((got_d - true_d).abs() / true_d).max())
    below = (d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    got_below = (got_d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    unique = bool((torch.sort(got_pos, dim=1).values.diff(dim=1) > 0).all())
    worst_out = float((got_d64 / kth - 1).max())
    check(dist_err <= KNN_DIST_RTOL, f"distances off float64 by up to {dist_err} relative")
    check(unique, "a query got the same item twice")
    check(worst_out <= KNN_TIE_RTOL, f"a returned item lies {worst_out} relative beyond the k-th distance")
    check(bool((below == got_below).all()), f"{int((below != got_below).sum())} rows miss an item off the tie band")
    swapped = int((got_d64 > kth * (1 - KNN_TIE_RTOL)).sum())
    del d2, d64
    torch.cuda.empty_cache()
    return {"sample": KNN_SAMPLE, "dist_max_rel_err": dist_err, "returned_in_tie_band": swapped,
            "dist_rtol": KNN_DIST_RTOL, "tie_rtol": KNN_TIE_RTOL}


def run_knn_path(torch, port, knn_ops, wrappers, X, Qh, dev):
    """The kNN arm through the public API.  Returns (record, model, indices,
    distances)."""
    item_df = port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Qh, num_partitions=KNN_QUERY_PARTS)
    search = knn_ops.knn_search_prepared
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    search.flagged_rows = search.rerun_rows = 0
    model = port.NearestNeighbors(k=KNN_K).fit(item_df)
    t0 = time.perf_counter()
    _, qdf, knn_df = model.kneighbors(query_df)
    first_s = time.perf_counter() - t0
    launches_first = read_launches(wrappers)
    t0 = time.perf_counter()
    knn_df2 = model.kneighbors(query_df)[2]
    kneighbors_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    flagged, rerun = search.flagged_rows, search.rerun_rows
    peak_bytes = torch.cuda.max_memory_allocated()
    for name in ("knn_candidates", "knn_fused_merge"):
        check(launches_first[name] > 0 and launches[name] > launches_first[name],
              f"kneighbors launched {name} no time in a call")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (KNN_QUERIES, KNN_K) and idx.dtype == np.int64 and dist.dtype == np.float32,
          f"kneighbors gave {idx.shape} {idx.dtype} / {dist.dtype}")
    check(bool(np.isfinite(dist).all()) and bool((np.diff(dist, axis=1) >= 0).all()), "distances not finite ascending")
    check(np.array_equal(idx, np.concatenate([p["indices"] for p in knn_df2.partitions]))
          and np.array_equal(dist, np.concatenate([p["distances"] for p in knn_df2.partitions])),
          "the cached kneighbors call gave other results")
    prepared = model._staged_items[1]
    f64 = check_against_float64(torch, prepared, Qh, idx, dist, dev)
    profile = profile_run(torch, lambda: model.kneighbors(query_df), KNN_PROFILE_RANGES, wrappers)
    t0 = time.perf_counter()
    join = model.exactNearestNeighborsJoin(port.DataFrame.from_numpy(Qh[:KNN_JOIN_QUERIES]))
    join_s = time.perf_counter() - t0
    join_rows = join.count()
    check(join_rows == KNN_JOIN_QUERIES * KNN_K, f"the join has {join_rows} rows")
    rec = {
        "phase": "path_knn", "items": KNN_ITEMS, "cols": X.shape[1], "queries": KNN_QUERIES, "k": KNN_K,
        "item_partitions": KNN_ITEM_PARTS, "query_partitions": KNN_QUERY_PARTS, "rows_cut": False,
        "m": knn_ops._scan_geometry(KNN_K, KNN_ITEMS)[1], "kernel_route": knn_ops._kernel_route(KNN_K, KNN_ITEMS)[0],
        "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s,
        "stage_s": first_s - kneighbors_s,  # staging: the first call less the cached one
        "kneighbors_rows_per_s": KNN_QUERIES / kneighbors_s,
        "launches_first_call": launches_first, "launches": launches,
        "flagged_rows": flagged, "rerun_rows": rerun,
        "max_memory_allocated_bytes": peak_bytes, "float64_check": f64, "profile": profile,
        "join_queries": KNN_JOIN_QUERIES, "join_rows": join_rows, "join_s": join_s,
    }
    return rec, model, idx, dist


def knn_audit(torch, knn_ops, wrappers, model, Qh, idx, dist, dev):
    """Phase knn_audit: one block through the audit route on the staged
    items."""
    search = knn_ops.knn_search_prepared
    qb = torch.from_numpy(Qh[:KNN_BLOCK]).to(dev)
    reset_launches(wrappers)
    search.flagged_rows = search.rerun_rows = 0
    search.count_failed_rows = search.count_failed_unflagged_rows = 0
    t0 = time.perf_counter()
    d_a, i_a = search(model._staged_items[1], qb, KNN_K, audit=True)
    audit_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    for name in ("knn_candidates_audit", "knn_fused_merge", "knn_count"):
        check(launches[name] > 0, f"the audit route launched {name} no time")
    check(launches["knn_candidates"] == 0, "the audit route launched the main path's pool wrapper")
    check(search.count_failed_unflagged_rows == 0,
          f"{search.count_failed_unflagged_rows} rows failed the count check without a flag")
    check(np.array_equal(i_a, idx[:KNN_BLOCK]) and np.array_equal(d_a, dist[:KNN_BLOCK]),
          "the audit route's results differ from the main path's")
    return {"phase": "knn_audit", "queries": KNN_BLOCK, "audit_s": audit_s, "launches": launches,
            "flagged_rows": search.flagged_rows, "count_failed_rows": search.count_failed_rows,
            "count_failed_unflagged_rows": search.count_failed_unflagged_rows, "rerun_rows": search.rerun_rows,
            "equal_to_main_path": True}




def knn_streamed(torch, port, knn_ops, wrappers, X, Qh, main_prepared, main_dist, dev):
    """Phase knn_streamed: the kNN items under an item budget of
    KNN_STREAM_BUDGET bytes, so kneighbors streams them in blocks.  The
    device must hold one block at a time, and the results must pass the
    float64 check."""
    real_budget = knn_ops._item_budget_bytes
    knn_ops._item_budget_bytes = lambda d: KNN_STREAM_BUDGET
    try:
        block_rows = knn_ops._item_block_rows(X.shape[1], dev)
        n_blocks = -(-len(X) // block_rows)
        Qs = Qh[:KNN_STREAM_QUERIES]
        model = port.NearestNeighbors(k=KNN_K).fit(port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS))
        query_df = port.DataFrame.from_numpy(Qs, num_partitions=KNN_QUERY_PARTS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wrappers)
        t0 = time.perf_counter()
        knn_df = model.kneighbors(query_df)[2]
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = read_launches(wrappers)
    finally:
        knn_ops._item_budget_bytes = real_budget
    block_bytes = block_rows * X.shape[1] * 4
    check(model._staged_items is None and n_blocks >= 2, f"the items were not streamed ({n_blocks} blocks)")
    for name in ("knn_candidates", "knn_fused_merge"):
        check(launches[name] == n_blocks * KNN_QUERY_PARTS, f"streamed kneighbors launched {name} {launches[name]} times")
    check(peak < 2 * block_bytes, f"streaming peaked at {peak} bytes: two {block_bytes}-byte blocks were resident")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (len(Qs), KNN_K), f"streamed kneighbors gave {idx.shape}")
    f64 = check_against_float64(torch, main_prepared, Qs, idx, dist, dev)
    dist_err = float(np.abs(dist - main_dist[: len(Qs)]).max())
    check(bool(np.allclose(dist, main_dist[: len(Qs)], rtol=KNN_DIST_RTOL, atol=0.0)),
          f"streamed distances off the in-core ones by up to {dist_err}")
    return {"phase": "knn_streamed", "items": len(X), "queries": len(Qs), "k": KNN_K,
            "item_budget_bytes": KNN_STREAM_BUDGET, "block_rows": block_rows, "blocks": n_blocks,
            "block_bytes": block_bytes, "peak_bytes_over_base": peak, "kneighbors_s": seconds,
            "launches": launches, "dist_max_abs_err_vs_in_core": dist_err, "float64_check": f64}


# ---------------------------------------------------------------------------
# The mesh: kernel B11 and exact kNN on 4 shards of one card
# ---------------------------------------------------------------------------

# Four shards of one card: the script needs one card, and 4 shards of the
# kNN arm's 400,000 items are 100,000 rows each, with no padding; a mesh that
# repeats a device is the port's counterpart of the JAX package's forced host
# device count.  The ring hop's blocks: 8,192 queries / 4 shards.
MESH_SHARDS = 4
RING_ROWS = KNN_BLOCK // MESH_SHARDS
EXCHANGE_SHIFTS = (1, -1, 3)
EXCHANGE_REPS = 50  # calls a B11 timing traces
# the ring against the one-shard exchange: distances within this relative
# error, ids equal off near-ties (KNN_TIE_RTOL)
RING_DIST_RTOL = 1e-6
# a ragged exchange block, as flagged rows come: padded to 64 rows, it runs
# the ring with (16, 3000) sub-tiles
RAGGED_ROWS = 37
KNN_MESH_DIST_RTOL = 1e-5  # the mesh kernel route against path_knn's


def bits_differ(torch, a, b):
    """Count of bytes whose bits differ between two tensors of one shape."""
    return int((a.reshape(-1).view(torch.uint8) != b.reshape(-1).view(torch.uint8).to(a.device)).sum())


def ring_permutation(n, shift):
    from spark_rapids_ml_tpu_torch.parallel.mesh import ring_permutation as port_ring_permutation

    return port_ring_permutation(n, shift)


def exchange_case(torch, ek, name, srcs, perm):
    """B11 against its plain version on one case: bit for bit, every block
    on its destination's device."""
    out, ref = ek.ring_shift(srcs, perm), ek.ring_shift_plain(srcs, perm)
    torch.cuda.synchronize()
    differ = sum(bits_differ(torch, a, b) for a, b in zip(out, ref))
    for d, t in enumerate(out):
        check(t.device == srcs[d].device, f"ring_shift {name}: block {d} landed on {t.device}")
    check(differ == 0, f"ring_shift {name} differs from its plain version in {differ} bytes")
    return {"case": name, "perm": [list(p) for p in perm], "shape": list(srcs[0].shape),
            "dtype": str(srcs[0].dtype), "bytes_differ": differ}


def exchange_rejections(torch, ek, blocks):
    """The typed rejections: each raises ValueError and launches nothing."""
    q, cd, cp = blocks
    n = len(q)
    rot = [(i, (i + 1) % n) for i in range(n)]
    cases = {
        "unequal_shape": (q[:-1] + [q[-1][:-1]], rot),
        "unequal_dtype": ([cd[0]] + cp[1:], rot),
        "more_than_64_pairs": ([cd[0]] * (ek.MAX_PAIRS + 1), [(i, (i + 1) % (ek.MAX_PAIRS + 1))
                                                               for i in range(ek.MAX_PAIRS + 1)]),
        "not_a_permutation": (cd, [(i, 0) for i in range(n)]),
        "not_contiguous": ([t.t() for t in cd], rot),
    }
    before = ek.ring_shift.launches
    for case, (srcs, perm) in cases.items():
        try:
            ek.ring_shift(srcs, perm)
        except ValueError:
            continue
        raise RuntimeError(f"ring_shift accepted the {case} case")
    check(ek.ring_shift.launches == before, "a rejected ring_shift launched its kernel")
    return sorted(cases)


def exchange_cases(torch, ek, topology, devices, gen):
    """B11 on the given shard devices: the ring hop's blocks (2,048 x 3000
    f32 queries, 2,048 x 200 f32 distances and i32 positions) at every shift
    of EXCHANGE_SHIFTS, misaligned blocks, the gateway cycles, the
    rejections.  Returns (records, the hop's blocks)."""
    n = len(devices)
    home = devices[0]
    q = [torch.randn(RING_ROWS, COLS, generator=gen, device=home).to(d) for d in devices]
    cd = [torch.randn(RING_ROWS, KNN_K, generator=gen, device=home).to(d) for d in devices]
    cp = [torch.randint(0, 2**31 - 1, (RING_ROWS, KNN_K), generator=gen, device=home, dtype=torch.int32).to(d)
          for d in devices]
    rows = []
    for name, blocks in (("query", q), ("cand_dist", cd), ("cand_pos", cp)):
        for shift in EXCHANGE_SHIFTS:
            rows.append(exchange_case(torch, ek, f"{name}_shift{shift}", blocks, ring_permutation(n, shift)))
    # one float past a 16-byte boundary (4-byte words), one byte past with a
    # ragged length (bytes)
    f = torch.randn(n, 1 + 7001, generator=gen, device=home)
    rows.append(exchange_case(torch, ek, "misaligned_f32", [f[i, 1:].to(d) if d != home else f[i, 1:]
                                                             for i, d in enumerate(devices)], ring_permutation(n, 1)))
    b = torch.randint(0, 256, (n, 1 + 1001), generator=gen, device=home, dtype=torch.uint8)
    rows.append(exchange_case(torch, ek, "misaligned_u8", [b[i, 1:] if d == home else b[i, 1:].to(d)
                                                            for i, d in enumerate(devices)], ring_permutation(n, 1)))
    maps = [("gateway_devs_per_host_2", topology.topology_map(devices=devices, devs_per_host=2))]
    if n == 4:
        maps.append(("gateway_interleaved", topology.TopologyMap(groups=((0, 2), (1, 3)), source="override")))
    for name, topo in maps:
        check(topo.is_hierarchical, f"{name}: {topo.describe()} is not hierarchical")
        for shift in (1, -1):
            rows.append(exchange_case(torch, ek, f"{name}_shift{shift}", q, topology.ring_cycle(topo, shift)))
    rejections = exchange_rejections(torch, ek, (q, cd, cp))
    return rows, rejections, (q, cd, cp)


def device_ms(torch, fn, reps, symbol=None):
    """(device ms per call of `fn`, traced launches) from one trace of `reps`
    calls after a warm-up call: the mean time of the traced launches of the
    port's kernel `symbol`, or the card's busy time (every kernel and copy)
    over the calls."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    rec = profile_once(torch, run, ())
    if symbol is None:
        return rec["device_busy_ms"] / reps, None
    traced = rec["port_launches"].get(symbol, 0)
    check(traced > 0, f"the trace holds no launch of {symbol}")
    return rec["port_kernel_ms"][symbol] / traced, traced


def check_exchange_kernel(torch, ek, topology, dev):
    """Phase kernels_exchange: B11 against its plain version on 4 shards of
    one card, bit for bit, then its times at the ring hop's shapes (library:
    torch.roll of the stacked blocks along the shard axis)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    devices = [dev] * MESH_SHARDS
    rows, rejections, blocks = exchange_cases(torch, ek, topology, devices, gen)
    timed = {}
    for name, srcs in zip(("query", "cand_dist", "cand_pos"), blocks):
        perm = ring_permutation(MESH_SHARDS, 1)
        stacked = torch.stack(srcs)
        rolled = torch.roll(stacked, 1, 0)
        check(all(torch.equal(a, b) for a, b in zip(ek.ring_shift(srcs, perm), rolled)),
              f"ring_shift {name} disagrees with torch.roll")
        kernel = lambda: ek.ring_shift(srcs, perm)  # noqa: E731
        plain = lambda: ek.ring_shift_plain(srcs, perm)  # noqa: E731
        library = lambda: torch.roll(stacked, 1, 0)  # noqa: E731
        # a shift takes tens of microseconds on the card, less than the
        # wrapper's host work, so CUDA events around a call time the host:
        # ms, plain_ms and library_ms are device times from a trace of
        # EXCHANGE_REPS calls, the event times are kept beside them
        r = {key[: -len("_ms")] + "_call_ms": ms
             for key, ms in timings(torch, kernel, plain, library, EXCHANGE_REPS).items()}
        r["kernel_ms"], r["traced_launches"] = device_ms(torch, kernel, EXCHANGE_REPS, "ring_shift_kernel")
        r["plain_ms"], _ = device_ms(torch, plain, EXCHANGE_REPS)
        r["library_ms"], _ = device_ms(torch, library, EXCHANGE_REPS)
        nbytes = MESH_SHARDS * srcs[0].numel() * srcs[0].element_size()
        r["bound_ms"], r["bound_by"] = bound(2.0 * nbytes, 0.0)
        timed[name] = {"shards": MESH_SHARDS, "shape": list(srcs[0].shape), "dtype": str(srcs[0].dtype),
                       "block_bytes": nbytes // MESH_SHARDS, **r, "max_abs_err": 0.0}
        del stacked, rolled
    del blocks
    torch.cuda.empty_cache()
    return {"phase": "kernels_exchange", "shards": MESH_SHARDS, "device": str(dev), "cases": rows,
            "rejections": rejections, "bit_exact": True, "ring_shift": timed["query"],
            "ring_shift_cand_dist": timed["cand_dist"], "ring_shift_cand_pos": timed["cand_pos"]}


def check_exchange_peer(torch, ek, topology):
    """Phase kernels_exchange_peer: the same cases over cuda:0 .. n-1 (at
    most 4), through peer pointers; skipped on a host with one card."""
    count = torch.cuda.device_count()
    if count < 2:
        return {"phase": "kernels_exchange_peer", "skipped": f"{count} CUDA device"}
    devices = [torch.device("cuda", i) for i in range(min(count, MESH_SHARDS))]
    gen = torch.Generator(device=devices[0]).manual_seed(SEED + 1)
    rows, rejections, blocks = exchange_cases(torch, ek, topology, devices, gen)
    q = blocks[0]
    perm = ring_permutation(len(devices), 1)
    ms, _ = device_ms(torch, lambda: ek.ring_shift(q, perm), EXCHANGE_REPS, "ring_shift_kernel")
    del blocks, q
    torch.cuda.empty_cache()
    return {"phase": "kernels_exchange_peer", "devices": [str(d) for d in devices], "cases": rows,
            "rejections": rejections, "bit_exact": True, "query_kernel_ms": ms,
            "knn_across_cards": knn_across_cards(torch, ek, devices)}


def knn_across_cards(torch, ek, devices):
    """The exact kNN search with its shards on several cards against the
    same shards on one card: the kernel route and one block through the
    ring and the gather, bit for bit (one launch of B11 per source card and
    call on the ring)."""
    from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

    n, rows, cols, queries = len(devices), 100_000, 256, 2048
    X = normal_data(n * rows, cols, KNN_ITEM_SEED)
    Q = normal_data(queries, cols, KNN_QUERY_SEED)
    ids = np.arange(n * rows)
    one = knn_ops.prepare_items(X, ids, Mesh([devices[0]] * n))
    cards = knn_ops.prepare_items(X, ids, Mesh(devices))
    qb = torch.from_numpy(Q).to(devices[0])
    rec = {"items": n * rows, "cols": cols, "queries": queries, "k": KNN_K}
    for route in ("ring", "gather"):
        before = ek.ring_shift.launches
        want = knn_ops._exact_block_search(one, qb, KNN_K, exchange=route)
        mid = ek.ring_shift.launches
        got = knn_ops._exact_block_search(cards, qb, KNN_K, exchange=route)
        torch.cuda.synchronize()
        differ = sum(bits_differ(torch, a, b) for a, b in zip(got, want))
        check(differ == 0, f"the {route} across {n} cards differs from one card in {differ} bytes")
        rec[f"{route}_launches_one_card"] = mid - before
        rec[f"{route}_launches_cards"] = ek.ring_shift.launches - mid
    check(rec["ring_launches_cards"] == 3 * n * n, f"the ring across cards launched B11 {rec['ring_launches_cards']}")
    want = knn_ops.knn_search_prepared(one, Q, KNN_K)
    got = knn_ops.knn_search_prepared(cards, Q, KNN_K)
    check(all(np.array_equal(a, b) for a, b in zip(got, want)), "the kernel route across cards differs from one card")
    rec["bit_exact"] = True
    del one, cards, qb
    torch.cuda.empty_cache()
    return rec


def near_tie_mismatches(torch, prepared, Qh, rows, pos_a, pos_b, dev):
    """(entries whose positions differ, of them those off near-ties): a
    differing pair of items must lie within KNN_TIE_RTOL of each other in
    float64 distance to the query."""
    differ = np.argwhere(pos_a != pos_b)
    if differ.size == 0:
        return 0, 0
    r, c = differ[:, 0], differ[:, 1]
    q = torch.from_numpy(Qh[rows[r]]).to(dev, torch.float64)
    items = prepared.items
    da = (items[torch.from_numpy(pos_a[r, c]).to(dev)].double() - q).norm(dim=1)
    db = (items[torch.from_numpy(pos_b[r, c]).to(dev)].double() - q).norm(dim=1)
    return len(r), int(((da - db).abs() > KNN_TIE_RTOL * db).sum())


def run_knn_mesh_path(torch, port, knn_ops, wrappers, X, Qh, single, single_idx, single_dist, dev, ranks_ref=None):
    """Phase path_knn_mesh: the kNN arm through the public API on a 4-shard
    mesh of one card: fit -> kneighbors twice, the float64 check, one
    profiled call; the results against path_knn's.  With `ranks_ref` (a
    dict) its first RANKS_KNN_QUERIES rows are kept for path_fit_ranks."""
    item_df = port.DataFrame.from_numpy(X, num_partitions=KNN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Qh, num_partitions=KNN_QUERY_PARTS)
    search = knn_ops.knn_search_prepared
    with port.device.use_device([dev] * MESH_SHARDS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wrappers)
        search.flagged_rows = search.rerun_rows = 0
        port.profiling.reset_counters()
        model = port.NearestNeighbors(k=KNN_K, num_workers=MESH_SHARDS).fit(item_df)
        t0 = time.perf_counter()
        knn_df = model.kneighbors(query_df)[2]
        first_s = time.perf_counter() - t0
        launches_first = read_launches(wrappers)
        t0 = time.perf_counter()
        knn_df2 = model.kneighbors(query_df)[2]
        kneighbors_s = time.perf_counter() - t0
        launches = read_launches(wrappers)
        counters = port.profiling.counters()
        flagged, rerun = search.flagged_rows, search.rerun_rows
        peak_bytes = torch.cuda.max_memory_allocated()
        prepared = model._staged_items[1]
        profile = profile_run(torch, lambda: model.kneighbors(query_df), KNN_PROFILE_RANGES, wrappers)
    n_loc = KNN_ITEMS // MESH_SHARDS
    check(len(prepared.shards) == MESH_SHARDS and all(sh.items.shape[0] == n_loc for sh in prepared.shards),
          "the items were not sharded 4 ways of 100,000 rows")
    blocks = -(-KNN_QUERIES // KNN_BLOCK)
    m = knn_ops._scan_geometry(KNN_K, n_loc)[1]
    check(launches_first["knn_candidates"] == MESH_SHARDS * blocks and launches_first["knn_fused_merge"] == blocks,
          f"a mesh kneighbors call launched B5 / B7 {launches_first['knn_candidates']} / "
          f"{launches_first['knn_fused_merge']} times")
    check(launches["knn_candidates"] == 2 * MESH_SHARDS * blocks, "the cached mesh call launched B5 otherwise")
    check(counters.get("exchange.knn.cand_pool.calls") == 2 * 2 * blocks, f"cand_pool gathers: {counters}")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])
    check(idx.shape == (KNN_QUERIES, KNN_K) and bool(np.isfinite(dist).all()), f"mesh kneighbors gave {idx.shape}")
    check(np.array_equal(idx, np.concatenate([p["indices"] for p in knn_df2.partitions]))
          and np.array_equal(dist, np.concatenate([p["distances"] for p in knn_df2.partitions])),
          "the cached mesh kneighbors call gave other results")
    dist_err = float((np.abs(dist - single_dist) / single_dist).max())
    check(dist_err <= KNN_MESH_DIST_RTOL, f"mesh distances off path_knn's by {dist_err} relative")
    pos_of_id = np.empty(KNN_ITEMS, np.int64)
    pos_of_id[single.ids] = np.arange(KNN_ITEMS)
    differ, off_tie = near_tie_mismatches(torch, single, Qh, np.arange(KNN_QUERIES), pos_of_id[idx],
                                          pos_of_id[single_idx], dev)
    check(off_tie == 0, f"{off_tie} mesh ids differ from path_knn's off near-ties")
    f64 = check_against_float64(torch, single, Qh, idx, dist, dev)
    if ranks_ref is not None:
        ranks_ref["knn"] = (idx[:RANKS_KNN_QUERIES].copy(), dist[:RANKS_KNN_QUERIES].copy())
        # the same items searched KNN_TIE_SLACK past k: every item at a
        # row's k-th distance, for path_fit_ranks' tie check
        with port.device.use_device([dev] * MESH_SHARDS):
            d_ext, i_ext = knn_ops.knn_search_prepared(prepared, Qh[:RANKS_KNN_QUERIES], KNN_K + KNN_TIE_SLACK)
        ranks_ref["knn_ties"] = (i_ext, d_ext)
    return {
        "phase": "path_knn_mesh", "shards": MESH_SHARDS, "mesh": [str(dev)] * MESH_SHARDS,
        "items": KNN_ITEMS, "cols": X.shape[1], "queries": KNN_QUERIES, "k": KNN_K, "rows_cut": False,
        "rows_per_shard": n_loc, "m": m, "groups_per_shard": -(-n_loc // 1024),
        "pool_per_query": MESH_SHARDS * -(-n_loc // 1024) * m,
        "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s, "stage_s": first_s - kneighbors_s,
        "kneighbors_rows_per_s": KNN_QUERIES / kneighbors_s,
        "launches_first_call": launches_first, "launches": launches,
        "exchange_counters": {k: v for k, v in counters.items() if not k.endswith("time_ns")},
        "flagged_rows": flagged, "rerun_rows": rerun, "max_memory_allocated_bytes": peak_bytes,
        "ids_differ_vs_path_knn": differ, "ids_differ_off_near_ties": off_tie,
        "dist_max_rel_err_vs_path_knn": dist_err, "float64_check": f64, "profile": profile,
    }, prepared


def knn_ring(torch, port, knn_ops, ek, wrappers, mesh_prepared, single, Qh, dev):
    """Phase knn_ring: one 8,192-query block through the exact exchange on
    the 4-shard mesh, ring and gather, and through the one-shard exchange:
    ring == gather bit for bit, 12 B11 launches on the ring and none on the
    gather, the section bytes of the per-hop model, and the one-shard result
    within RING_DIST_RTOL (ids equal off near-ties)."""
    qb = torch.from_numpy(Qh[:KNN_BLOCK]).to(dev)
    out, rec = {}, {"phase": "knn_ring", "shards": MESH_SHARDS, "queries": KNN_BLOCK, "k": KNN_K}
    for route in ("ring", "gather"):
        torch.cuda.synchronize()
        reset_launches(wrappers)
        port.profiling.reset_counters()
        t0 = time.perf_counter()
        out[route] = knn_ops._exact_block_search(mesh_prepared, qb, KNN_K, exchange=route)
        torch.cuda.synchronize()
        rec[f"{route}_s"] = time.perf_counter() - t0
        rec[f"launches_{route}"] = read_launches(wrappers)
        rec[f"counters_{route}"] = {k: v for k, v in port.profiling.counters().items() if not k.endswith("time_ns")}
    (rd, rp), (gd, gp) = out["ring"], out["gather"]
    differ = bits_differ(torch, rd, gd) + bits_differ(torch, rp, gp)
    check(differ == 0, f"ring and gather differ in {differ} bytes")
    check(rec["launches_ring"]["ring_shift"] == 3 * MESH_SHARDS, f"the ring launched B11 {rec['launches_ring']}")
    check(rec["launches_gather"]["ring_shift"] == 0, "the gather launched B11")
    ctr = rec["counters_ring"]
    want_q = MESH_SHARDS * RING_ROWS * COLS * 4
    want_c = MESH_SHARDS * 2 * RING_ROWS * KNN_K * 4
    check(ctr.get("exchange.knn.ring_q.bytes") == want_q and ctr.get("exchange.knn.ring_cand.bytes") == want_c,
          f"ring section bytes {ctr} against the model {want_q} / {want_c}")
    check(rec["counters_ring"].get("knn.exchange_route.ring") == 1
          and rec["counters_gather"].get("knn.exchange_route.gather") == 1, "the route counters")
    n1 = single.items.shape[0]
    chunk, qt = knn_ops._exchange_geometry(n1, KNN_BLOCK, 1, "ring")
    ring_geometry = knn_ops._exchange_geometry(n1 // MESH_SHARDS, KNN_BLOCK, MESH_SHARDS, "ring")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    od, op = knn_ops.knn_block_kernel_exchange(single, qb, KNN_K, "ring", chunk, qt)
    torch.cuda.synchronize()
    rec["one_shard_s"] = time.perf_counter() - t0
    rec["geometry_one_shard"], rec["geometry_ring"] = [chunk, qt], list(ring_geometry)
    rec["bytes_differ_vs_one_shard"] = bits_differ(torch, rd, od) + bits_differ(torch, rp, op)
    dist_err = float(((rd.double() - od.double()).abs() / od.double()).max())
    check(dist_err <= RING_DIST_RTOL, f"ring distances off the one-shard exchange by {dist_err} relative")
    pa, pb = rp.cpu().numpy(), op.cpu().numpy()
    rec["ids_differ_vs_one_shard"], off_tie = near_tie_mismatches(torch, single, Qh, np.arange(KNN_BLOCK), pa, pb, dev)
    check(off_tie == 0, f"{off_tie} ring ids differ from the one-shard exchange off near-ties")
    rec["dist_max_rel_err_vs_one_shard"] = dist_err
    # a ragged block pads onto the ring: 12 B11 launches, rows as the block's
    torch.cuda.synchronize()
    reset_launches(wrappers)
    port.profiling.reset_counters()
    t0 = time.perf_counter()
    xd, xp = knn_ops._exact_block_search(mesh_prepared, qb[:RAGGED_ROWS], KNN_K)
    torch.cuda.synchronize()
    rec["ragged_s"] = time.perf_counter() - t0
    rec["ragged_rows"], rec["ragged_padded_rows"] = RAGGED_ROWS, knn_ops._exchange_rows(RAGGED_ROWS, MESH_SHARDS)
    rec["launches_ragged"] = read_launches(wrappers)
    check(port.profiling.counters("knn.exchange_route.") == {"knn.exchange_route.ring": 1}
          and rec["launches_ragged"]["ring_shift"] == 3 * MESH_SHARDS,
          f"the ragged block: routes {port.profiling.counters('knn.exchange_route.')}, "
          f"launches {rec['launches_ragged']}")
    rec["ragged_bytes_differ_vs_block"] = bits_differ(torch, xd, rd[:RAGGED_ROWS]) + bits_differ(
        torch, xp, rp[:RAGGED_ROWS])
    ragged_err = float(((xd.double() - rd[:RAGGED_ROWS].double()).abs() / rd[:RAGGED_ROWS].double()).max())
    check(ragged_err <= RING_DIST_RTOL, f"the ragged block's distances off the block's by {ragged_err} relative")
    rec["ragged_ids_differ_vs_block"], off_tie = near_tie_mismatches(
        torch, single, Qh, np.arange(RAGGED_ROWS), xp.cpu().numpy(), pa[:RAGGED_ROWS], dev)
    check(off_tie == 0, f"{off_tie} ragged-block ids differ from the block's off near-ties")
    rec["ragged_dist_max_rel_err_vs_block"] = ragged_err
    # the share of the ring's time in B11: one profiled ring call
    prof = profile_run(torch, lambda: knn_ops._exact_block_search(mesh_prepared, qb, KNN_K, exchange="ring"),
                       (), wrappers)
    b11_ms = prof["port_kernel_ms"].get("ring_shift_kernel", 0.0)
    rec["profile"] = prof
    rec["ring_shift_device_ms"] = b11_ms
    rec["ring_shift_share"] = b11_ms / prof["profiled_ms"]
    rec["equal_ring_gather"] = True
    del out, od, op, xd, xp
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# ANN: kernels B9-B10 (B1 and B7 at the ANN shapes) and the JAX package's
# three ANN operating points
# ---------------------------------------------------------------------------

# The JAX package's ANN arms (bench.py:379-442, its generator bench.py:150):
# 400,000 x 256 float32 items around 632 blob centres drawn as 10 * N(0, 1),
# labels uniform over the blobs, N(0, 1) noise, all from
# np.random.default_rng(42); the queries are the first 16,384 rows; k = 200,
# nlist = default_nlist(400,000) = 632, nprobe = default_nprobe(632) = 158,
# M = default_m_sub(256) = 32.  The 4-bit arm is the fast-scan operating
# point of ci/test.sh:711-714 (n_bits 4, opq, refine_ratio 8).  The items
# and widths are not cut; the queries are the first 8,192 (cut from 16,384
# to keep the whole script under its time limit: the PQ arms' host refine,
# two calls an arm, grows with the queries).
ANN_ITEMS, ANN_COLS, ANN_QUERIES, ANN_K, ANN_SEED = 400_000, 256, 8_192, 200, 42
ANN_NLIST, ANN_NPROBE, ANN_M = 632, 158, 32
ANN_ITEM_PARTS, ANN_QUERY_PARTS = 8, 2
ANN_CHECK_QUERIES = 2048   # the recall, reload and tiered checks
# the profiled call's queries: the first quarter of the timed calls' (cut
# from 16,384, then 4,096, to keep the whole script under its time limit:
# the PQ arms' host refine grows with the queries)
ANN_PROFILE_QUERIES = 2048
_ANN_BASE = {"nlist": ANN_NLIST, "nprobe": ANN_NPROBE}
# phase: (algorithm, algoParams, recall@10 gate of the JAX package's tests)
ANN_ARMS = {
    "path_ann": ("ivfflat", dict(_ANN_BASE), 0.95),                    # tests/test_ann_engine.py:107
    "path_ann_pq": ("ivfpq", dict(_ANN_BASE, M=ANN_M, n_bits=8, refine_ratio=4), 0.9),  # test_pq_engine.py:176
    "path_ann_pq4": ("ivfpq", dict(_ANN_BASE, M=ANN_M, n_bits=4, opq=True, refine_ratio=8), 0.9),  # :468
}
ANN_HOT_FRACTION = 0.5
ANN_PROFILE_RANGES = ("ann.select", "ann.scan", "ann.merge")
# B9 / B10 checks, (B, R, m_sub, ksub, codes drawn below): the JAX test
# shapes, a ragged R with ksub < 256 and codes past it, tables of two
# stages, misaligned codes (byte loads), more than 65,535 queries
LUT_CASES = [
    (3, 700, 4, 16, 16), (1, 512, 2, 256, 256), (2, 33, 8, 5, 5), (2, 1001, 32, 200, 256),
    (2, 1000, 48, 256, 256), (3, 517, 64, 256, 256), (65537, 3, 2, 16, 16),
]
FASTSCAN_CASES = [
    (3, 700, 4, 16, 16), (1, 512, 2, 16, 16), (2, 33, 8, 5, 16), (2, 1001, 32, 16, 16),
    (3, 517, 64, 9, 16), (65537, 3, 2, 16, 16),
]
# the padded list length the port's fit gives on these items (each path
# records its own); the path-sized calls of B7, B9 and B10 take the query
# rows of one launch from ivfflat.sweep_geometry at this length
ANN_L_PAD = 2048
# B7 at the ANN pool: the k of each arm's merge (flat, 8-bit refine x4,
# 4-bit refine x8)
ANN_MERGE_KS = (200, 800, 1600)
# lut_accumulate_probed at ragged shapes, (B, nprobe, n_planes, L_pad,
# m_sub, ksub, code range, misaligned): counts from below 0 to past L_pad,
# slots outside the plane, codes past ksub, byte loads (m_sub 20), a table
# staged in parts (64 x 256), a misaligned plane, more than 65,535 queries
PROBED_CASES = [
    (3, 5, 9, 700, 32, 256, 256, False), (4, 7, 6, 333, 20, 16, 32, False), (2, 3, 5, 517, 64, 256, 256, False),
    (3, 4, 8, 256, 32, 200, 256, True), (65537, 2, 4, 3, 16, 16, 16, False),
]
# fastscan_lut_accumulate_probed at ragged shapes, the same fields (codes
# drawn below the range, then packed two a byte): the 4-bit arm's m_sub,
# nibbles past ksub, byte loads (m_sub 20), two register-table chunks (m_sub
# 64), a misaligned plane, L_pad not a multiple of the 128-row warp unit,
# more than 65,535 queries
FASTSCAN_PROBED_CASES = [
    (3, 5, 9, 700, 32, 16, 16, False), (4, 7, 6, 333, 20, 9, 16, False), (2, 3, 5, 517, 64, 16, 16, False),
    (3, 4, 8, 256, 32, 5, 16, True), (65537, 2, 4, 3, 2, 16, 16, False),
]


def ann_data():
    """The ANN arms' items, made as bench.py makes them, and the queries."""
    rng = np.random.default_rng(ANN_SEED)
    centers = 10.0 * rng.standard_normal((max(32, ANN_NLIST), ANN_COLS), dtype=np.float32)
    lab = rng.integers(0, centers.shape[0], size=ANN_ITEMS)
    X = centers[lab] + rng.standard_normal((ANN_ITEMS, ANN_COLS), dtype=np.float32)
    return X, X[:ANN_QUERIES].copy()


def lut_case(torch, pk, dev, gen, b, r, m_sub, ksub, hi, packed, misaligned=False):
    """B9 (or B10 when packed) against its plain version at one shape: bit
    for bit.  Returns (tables, codes, record)."""
    T = torch.randn((b, m_sub, ksub), generator=gen, device=dev)
    C = torch.randint(0, hi, (b, r, m_sub), generator=gen, device=dev, dtype=torch.uint8)
    if packed:
        C = (C[:, :, 0::2] | (C[:, :, 1::2] << 4)).contiguous()
    if misaligned:  # the same bytes one byte past a 16-byte boundary
        buf = torch.empty(C.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:].copy_(C.view(-1))
        C = buf[1:].view(C.shape)
    kernel, plain = ((pk.fastscan_lut_accumulate, pk.fastscan_lut_accumulate_plain) if packed
                     else (pk.lut_accumulate, pk.lut_accumulate_plain))
    got, want = kernel(T, C), plain(T, C)
    torch.cuda.synchronize()
    mismatches = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(mismatches == 0, f"{'fastscan' if packed else 'lut'} ({b}, {r}, {m_sub}, {ksub}) differs from its plain "
                           f"version at {mismatches} values")
    return T, C, {"b": b, "r": r, "m_sub": m_sub, "ksub": ksub, "code_range": hi, "misaligned": misaligned,
                  "bit_mismatches": mismatches}


def lut_timing(torch, pk, T, C, packed):
    """B9 / B10 at one shape: kernel, plain and library times (gather + sum
    over j, a yardstick only), and the least time (codes, tables and
    output moved once)."""
    b, r = C.shape[0], C.shape[1]
    kernel, plain = ((pk.fastscan_lut_accumulate, pk.fastscan_lut_accumulate_plain) if packed
                     else (pk.lut_accumulate, pk.lut_accumulate_plain))

    def library():
        codes = pk.unpack_codes4(C) if packed else C
        return T.gather(2, codes.long().transpose(1, 2)).sum(dim=1)

    lib = library()
    check(bool(torch.allclose(lib, kernel(T, C), rtol=1e-5, atol=1e-4)), "the gather + sum yardstick disagrees")
    del lib
    row = timings(torch, lambda: kernel(T, C), lambda: plain(T, C), library, 20)
    row["bound_ms"], row["bound_by"] = bound(C.numel() + 4.0 * b * r + 4.0 * T.numel(), float(b * r * T.shape[1]))
    return {"b": b, "r": r, "m_sub": T.shape[1], "ksub": T.shape[2], "max_abs_err": 0.0, **row}


def scan_rows(ivf, pq_mod, n_bits):
    """Query rows of one B9 / B10 launch on the PQ arms: the sweep's
    sub-block at ANN_L_PAD."""
    index = types.SimpleNamespace(m_sub=ANN_M, fastscan=n_bits == 4, l_pad=ANN_L_PAD)
    return ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * ANN_L_PAD, pq_mod.pq_tile_bytes(index, ANN_NPROBE))[1]


def ann_pool(torch, dev, gen, rows, tied):
    """A probe pool of the ANN arms' shape: rows x ANN_NPROBE distinct lists
    of ANN_L_PAD slots, each list holding Binomial(ANN_ITEMS, 1 / ANN_NLIST)
    items (mean 633: ~69% of the slots -inf), -d2 as tied integers in
    [-4096, -1] or continuous, positions list * L_pad + slot, the sentinel
    where invalid (ivfflat.probe_pool's layout)."""
    counts = torch.from_numpy(np.random.default_rng(SEED).binomial(ANN_ITEMS, 1.0 / ANN_NLIST, (rows, ANN_NPROBE)))
    counts = counts.to(device=dev, dtype=torch.int32)
    lists = torch.rand(rows, ANN_NLIST, generator=gen, device=dev).argsort(dim=1)[:, :ANN_NPROBE].sort(dim=1).values
    slot = torch.arange(ANN_L_PAD, device=dev, dtype=torch.int32)
    valid = slot[None, None, :] < counts[:, :, None]
    shape = (rows, ANN_NPROBE, ANN_L_PAD)
    if tied:
        v = -torch.randint(1, 4097, shape, generator=gen, device=dev).float()
    else:
        v = -(torch.rand(shape, generator=gen, device=dev) * 2000.0 + 100.0)
    v = torch.where(valid, v, torch.full_like(v, float("-inf")))
    p = torch.where(valid, lists.to(torch.int32)[:, :, None] * ANN_L_PAD + slot, torch.full_like(slot, 2**31 - 1))
    return v.contiguous(), p.contiguous(), float((~valid).float().mean())


def check_ann_merge(torch, kk, ivf, dev, gen):
    """B7 at the ANN arms' pool (one sweep block of query rows x 158 x 2048)
    at k = 200 / 800 / 1600: bit for bit against its plain version on tied
    integer values, through the route the wrapper takes and through the
    windowed kernel (the first design); timed (the route, the windowed
    kernel, the plain version, torch.topk over the pool) on continuous
    values."""
    rows = ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * ANN_L_PAD, 1)[0]
    out_rows = []
    for tied in (True, False):
        v, p, neg_share = ann_pool(torch, dev, gen, rows, tied)
        P = ANN_NPROBE * ANN_L_PAD
        for k in ANN_MERGE_KS:
            rec = {"q": rows, "nprobe": ANN_NPROBE, "l_pad": ANN_L_PAD, "pool": P, "k": k, "tied": tied,
                   "neg_inf_share": neg_share, "route": list(kk._merge_route(P, k))}
            if tied:
                ref = kk.knn_fused_merge_plain(v, p, k)
                rec["mismatches"] = merge_mismatches(torch, kk.knn_fused_merge(v, p, k), ref)
                rec["window_mismatches"] = merge_mismatches(torch, kk._merge_cuda(v, p, k, 0), ref)
                check(sum(rec["mismatches"]) + sum(rec["window_mismatches"]) == 0,
                      f"B7 at the ANN pool differs from its plain version: {rec}")
                del ref
            else:
                rec.update(timings(torch, lambda: kk.knn_fused_merge(v, p, k),
                                   lambda: kk.knn_fused_merge_plain(v, p, k),
                                   (lambda: torch.topk(v.view(rows, P), k, dim=1)) if k <= P else None, 10))
                rec["window_ms"] = median_ms(torch, lambda: kk._merge_cuda(v, p, k, 0), 5)
                rec["bound_ms"], rec["bound_by"] = merge_bound(rows, P, k)
                rec["max_abs_err"] = 0.0
            out_rows.append(rec)
            emit({"phase": "kernels_ann_merge", **rec})
        del v, p
        torch.cuda.empty_cache()
    return out_rows


def probed_inputs(torch, dev, gen, b, nprobe, n_planes, l_pad, m_sub, ksub, hi, misaligned, packed=False):
    """Tables, a code plane (packed: two 4-bit codes a byte), slots and
    counts for the probed entries: ragged counts (below 0, 0, past L_pad)
    and slots (some outside the plane)."""
    T = torch.randn((b, m_sub, ksub), generator=gen, device=dev)
    plane = torch.randint(0, hi, (n_planes, l_pad, m_sub), generator=gen, device=dev, dtype=torch.uint8)
    if packed:
        plane = (plane[:, :, 0::2] | (plane[:, :, 1::2] << 4)).contiguous()
    if misaligned:  # the same bytes one byte past a 16-byte boundary
        buf = torch.empty(plane.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:].copy_(plane.view(-1))
        plane = buf[1:].view(plane.shape)
    slots = torch.randint(-1, n_planes + 1, (b, nprobe), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.randint(-2, l_pad + 3, (b, nprobe), generator=gen, device=dev, dtype=torch.int32)
    counts[:, 0] = 0
    return T, plane, slots, counts


def probed_pair(pk, packed):
    """(kernel wrapper, plain version) of the probed entry: B10's when
    packed, else B9's."""
    return ((pk.fastscan_lut_accumulate_probed, pk.fastscan_lut_accumulate_probed_plain) if packed
            else (pk.lut_accumulate_probed, pk.lut_accumulate_probed_plain))


def probed_bits(torch, pk, T, plane, slots, counts, packed=False):
    kernel, plain = probed_pair(pk, packed)
    got = kernel(T, plane, slots, counts)
    want = plain(T, plane, slots, counts)
    torch.cuda.synchronize()
    return got, int((got.view(torch.int32) != want.view(torch.int32)).sum())


def check_probed_path(torch, pk, dev, gen, b, packed=False):
    """A probed entry at its arm's launch: b queries x 158 probed lists of
    an index plane (nlist_pad 640 x 2048) with Binomial(400,000, 1/632)
    items a list (8 lists empty), resident and through a tiered index's pool
    planes (ann/tier.TieredListPlanes, hot fraction 0.5): bit for bit
    against the plain version, the tiered rows bit for bit the resident
    ones; timed resident.  B9 (8-bit arm: m_sub 32 bytes a row, ksub 256)
    or, packed, B10 (4-bit arm: 16 packed bytes a row, ksub 16).  Library: index_select + (unpack +) gather +
    sum over j, masked."""
    from spark_rapids_ml_tpu_torch.ann.tier import TieredListPlanes

    name = "fastscan_lut_accumulate_probed" if packed else "lut_accumulate_probed"
    kernel, plain = probed_pair(pk, packed)
    ksub, m_bytes = (16, ANN_M // 2) if packed else (256, ANN_M)
    n_lists = 640
    rng = np.random.default_rng(SEED)
    list_counts = rng.binomial(ANN_ITEMS, 1.0 / ANN_NLIST, n_lists).astype(np.int32)
    list_counts[ANN_NLIST:] = 0
    list_counts[rng.choice(ANN_NLIST, 8, replace=False)] = 0
    host_plane = rng.integers(0, 256, (n_lists, ANN_L_PAD, m_bytes), dtype=np.uint8)
    plane = torch.from_numpy(host_plane).to(dev)
    counts_dev = torch.from_numpy(list_counts).to(dev)
    probes = torch.rand(b, ANN_NLIST, generator=gen, device=dev).argsort(dim=1)[:, :ANN_NPROBE].sort(dim=1).values
    counts = counts_dev[probes]
    T = torch.randn((b, ANN_M, ksub), generator=gen, device=dev)
    got, bad = probed_bits(torch, pk, T, plane, probes, counts, packed)
    check(bad == 0, f"{name} at the path's launch differs from its plain version at {bad} values")
    valid_rows = int(counts.clamp(0, ANN_L_PAD).sum())

    tier = TieredListPlanes(planes=[host_plane], sentinels=[None], counts=list_counts, device=dev,
                            hot_fraction=ANN_HOT_FRACTION)
    host_probes = probes.cpu().numpy()
    groups, tier_bad, tier_vs_resident = tier.plan_groups(host_probes), 0, 0
    for s0, e0 in groups:
        planes, slot_map = tier.acquire(host_probes[s0:e0].ravel())
        slots = slot_map[probes]
        t_got, t_bad = probed_bits(torch, pk, T, planes[0], slots, counts, packed)
        tier_bad += t_bad
        tier_vs_resident += int((t_got[s0:e0].view(torch.int32) != got[s0:e0].view(torch.int32)).sum())
    check(tier_bad == 0 and tier_vs_resident == 0,
          f"{name} on the tier's planes: {tier_bad} values off the plain version, "
          f"{tier_vs_resident} off the resident result")

    def library():
        tile = plane.index_select(0, probes.reshape(-1)).view(b, ANN_NPROBE * ANN_L_PAD, m_bytes)
        codes = pk.unpack_codes4(tile) if packed else tile
        acc = T.gather(2, codes.long().transpose(1, 2)).sum(dim=1).view(b, ANN_NPROBE, ANN_L_PAD)
        valid = torch.arange(ANN_L_PAD, device=dev)[None, None, :] < counts[:, :, None]
        return torch.where(valid, acc, torch.full_like(acc, float("inf")))

    lib = library()
    finite = torch.isfinite(got)
    check(bool(torch.allclose(lib[finite], got[finite], rtol=1e-5, atol=1e-4)), "the gather + sum yardstick disagrees")
    del lib
    torch.cuda.empty_cache()
    row = timings(torch, lambda: kernel(T, plane, probes, counts), lambda: plain(T, plane, probes, counts),
                  library, 20)
    all_rows = b * ANN_NPROBE * ANN_L_PAD
    # codes of the valid rows read, every output row written, the tables
    # and the slots and counts read once
    row["bound_ms"], row["bound_by"] = bound(
        valid_rows * m_bytes + 4.0 * all_rows + 4.0 * T.numel() + 12.0 * b * ANN_NPROBE, float(valid_rows * ANN_M))
    rec = {"b": b, "nprobe": ANN_NPROBE, "l_pad": ANN_L_PAD, "m_sub": ANN_M, "ksub": ksub,
           "r": ANN_NPROBE * ANN_L_PAD, "valid_rows": valid_rows, "valid_share": valid_rows / all_rows,
           "bit_mismatches": bad, "tier_groups": len(groups), "tier_bit_mismatches": tier_bad,
           "tier_vs_resident": tier_vs_resident, "tier": tier.stats(), "max_abs_err": 0.0, **row}
    vec = pk._vec(plane)
    if packed:
        rec["blocks_per_query"] = pk.fastscan_splits(T, ANN_NPROBE, ANN_L_PAD, vec)
        rec["resident_blocks_per_sm"] = pk.fastscan_resident_blocks(vec)
    else:
        rec["blocks_per_query"] = pk.probed_splits(T, ANN_NPROBE, ANN_L_PAD, vec)
        rec["resident_blocks_per_sm"] = pk.resident_blocks(ANN_M, 256, vec)
    return rec


def check_ann_kernels(torch, pk, kk, nc, ivf, pq_mod, _build, dev):
    """Phase kernels_ann: B9 and B10 against their plain versions on the
    card, bit for bit: the contiguous forms at the cases above, the probed
    entries at ragged cases and at their arms' launches (resident and
    tiered, timed there); B10's typed
    rejections; B7 at the ANN pool (check_ann_merge); B1 at the ANN fit's
    two shapes (list assignment, PQ encoding); ptxas registers and spills of
    the two kernels of csrc/pq_lut.cu."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    merge = check_ann_merge(torch, kk, ivf, dev, gen)
    build = ptxas_record(_build, "pq_lut", ("probed_lut_kernel", "fastscan_probed_kernel"))
    lut = [lut_case(torch, pk, dev, gen, *c, packed=False)[2] for c in LUT_CASES]
    lut.append(lut_case(torch, pk, dev, gen, 2, 999, 32, 256, 256, packed=False, misaligned=True)[2])
    fast = [lut_case(torch, pk, dev, gen, *c, packed=True)[2] for c in FASTSCAN_CASES]
    fast.append(lut_case(torch, pk, dev, gen, 2, 999, 64, 16, 16, packed=True, misaligned=True)[2])
    probed = []
    for packed, cases in ((False, PROBED_CASES), (True, FASTSCAN_PROBED_CASES)):
        for case in cases:
            inputs = probed_inputs(torch, dev, gen, *case, packed=packed)
            bad = probed_bits(torch, pk, *inputs, packed=packed)[1]
            check(bad == 0, f"{probed_pair(pk, packed)[0].__name__} {case} differs from its plain version at "
                            f"{bad} values")
            probed.append({"packed": packed, "case": list(case), "bit_mismatches": bad})
    rejections = {}
    for name, t_shape, p_shape, match in (
        ("odd_m_sub", (1, 3, 16), (1, 5, 1), "even"),
        ("ksub_over_16", (1, 4, 17), (1, 5, 2), "16"),
        ("packed_width", (1, 4, 16), (1, 5, 3), "bytes/item"),
    ):
        for entry in ("contiguous", "probed"):
            T0 = torch.zeros(t_shape, device=dev)
            C0 = torch.zeros(p_shape, dtype=torch.uint8, device=dev)
            try:
                if entry == "contiguous":
                    pk.fastscan_lut_accumulate(T0, C0)
                else:
                    zeros = torch.zeros((1, 2), dtype=torch.int32, device=dev)
                    pk.fastscan_lut_accumulate_probed(T0, C0, zeros, zeros)
            except ValueError as e:
                check(match in str(e), f"fast-scan {entry} {name}: {e}")
                rejections[f"{entry}_{name}"] = str(e)
            else:
                raise RuntimeError(f"fast-scan {entry} accepted {name}")
    torch.cuda.empty_cache()
    probed_row = check_probed_path(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 8))
    emit({"phase": "kernels_ann_probed", **probed_row})
    torch.cuda.empty_cache()
    fast_probed_row = check_probed_path(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 4), packed=True)
    emit({"phase": "kernels_ann_fastscan_probed", **fast_probed_row})
    torch.cuda.empty_cache()
    r_path = ANN_NPROBE * ANN_L_PAD
    T, C, fast_path = lut_case(torch, pk, dev, gen, scan_rows(ivf, pq_mod, 4), r_path, ANN_M, 16, 16, packed=True)
    fast_row = {**fast_path, **lut_timing(torch, pk, T, C, True)}
    del T, C
    torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(SEED)
    b1 = [check_kernel_shape(torch, nc, ANN_ITEMS, d, k, cpu_gen, dev) for d, k in ((ANN_COLS, ANN_NLIST), (8, 256))]
    return {"phase": "kernels_ann", "lut_build": build, "lut_cases": lut, "fastscan_cases": fast,
            "probed_cases": probed, "fastscan_rejections": rejections, "lut_accumulate_probed": probed_row,
            "fastscan_lut_accumulate_probed": fast_probed_row, "fastscan_lut_accumulate": fast_row,
            "knn_fused_merge_ann": merge, "min_dist_argmin_ann": b1}


def ann_rows(model, df):
    """(ids, distances) of kneighbors over `df`, partitions concatenated."""
    knn_df = model.kneighbors(df)[2]
    return (np.concatenate([p["indices"] for p in knn_df.partitions]),
            np.concatenate([p["distances"] for p in knn_df.partitions]))


def ann_merge_check(torch, ivf, pq_mod, knn_ops, kk, index, Q, k, pq, dev):
    """One probed block of 64 queries: B7 (the search's merge) against
    ops/knn.lex_topk on the same pool, bit for bit."""
    qb = torch.from_numpy(Q[:64]).to(dev)
    if pq:
        qb = torch.nn.functional.pad(qb, (0, index.d_pad - qb.shape[1]))
        if index.rotation is not None:
            qb = qb @ torch.from_numpy(index.rotation).to(dev).T
        scorer, tile = pq_mod.pq_block_scorer(index), pq_mod.pq_tile_bytes(index, ANN_NPROBE)
    else:
        scorer, tile = ivf._flat_block_scorer, ivf.flat_tile_bytes(index, ANN_NPROBE)
    _, sub_rows = ivf.sweep_geometry(64, ANN_NPROBE * index.l_pad, tile)
    vals, pos = ivf.probe_pool(index, qb, ANN_NPROBE, scorer, sub_rows)
    dist, fpos = kk.knn_fused_merge(vals, pos, k)[:2]
    fpos = torch.where(torch.isinf(dist), knn_ops.LEX_POS_SENTINEL, fpos)
    d2, lpos = knn_ops.lex_topk(-vals.view(64, -1), pos.view(64, -1), k)
    ldist = kk.sqrt_clamped(d2)
    torch.cuda.synchronize()
    bad = int((dist.view(torch.int32) != ldist.view(torch.int32)).sum() + (fpos != lpos).sum())
    check(bad == 0, f"the probe merge differs from lex_topk at {bad} values")
    return {"queries": 64, "pool": vals.shape[1] * vals.shape[2], "k": k, "mismatches": bad}


def run_ann_arm(torch, port, ivf, pq_mod, knn_ops, kk, wrappers, phase, X, Q, dev, keep=None):
    """One ANN arm through the public API: fit, kneighbors twice (staging,
    then the cached call) and one profiled call with the launch counters
    read around them; then recall@10 / @200 against exactSearch, save ->
    load, B7 against lex_topk on one block and, for the 4-bit arm, the
    tiered search against the resident one, on ANN_CHECK_QUERIES queries."""
    algorithm, params, gate = ANN_ARMS[phase]
    pq, fast = algorithm == "ivfpq", params.get("n_bits") == 4
    item_df = port.DataFrame.from_numpy(X, num_partitions=ANN_ITEM_PARTS)
    query_df = port.DataFrame.from_numpy(Q, num_partitions=ANN_QUERY_PARTS)
    check_df = port.DataFrame.from_numpy(Q[:ANN_CHECK_QUERIES])
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = port.ApproximateNearestNeighbors(k=ANN_K, algorithm=algorithm, algoParams=params).fit(item_df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_launches(wrappers)
    t0 = time.perf_counter()
    idx, dist = ann_rows(model, query_df)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx2, dist2 = ann_rows(model, query_df)
    kneighbors_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    peak_bytes = torch.cuda.max_memory_allocated()
    search = {name: launches[name] - launches_fit[name] for name in launches}
    check(launches_fit["min_dist_argmin"] > 0, "the fit launched min_dist_argmin no time")
    check(search["knn_fused_merge"] > 0, "kneighbors launched knn_fused_merge no time")
    for name, used in (("lut_accumulate_probed", pq and not fast), ("fastscan_lut_accumulate_probed", pq and fast),
                       ("lut_accumulate", False), ("fastscan_lut_accumulate", False)):
        check((search[name] > 0) == used, f"kneighbors launched {name} {search[name]} times")
    check(idx.shape == (ANN_QUERIES, ANN_K) and idx.dtype == np.int64 and dist.dtype == np.float32,
          f"kneighbors gave {idx.shape} {idx.dtype} / {dist.dtype}")
    check(bool(np.isfinite(dist).all()) and bool((np.diff(dist, axis=1) >= 0).all()) and bool((idx >= 0).all()),
          "distances not finite ascending, or an unfilled slot")
    check(np.array_equal(idx, idx2) and np.array_equal(dist, dist2), "the cached kneighbors call gave other results")
    profile_df = port.DataFrame.from_numpy(Q[:ANN_PROFILE_QUERIES], num_partitions=ANN_QUERY_PARTS)
    profiled = {}
    profile = profile_run(torch, lambda: profiled.update(rows=ann_rows(model, profile_df)), ANN_PROFILE_RANGES,
                          wrappers)
    profile["queries"] = ANN_PROFILE_QUERIES
    rec = {"index_bytes_per_item": model.index_bytes_per_item()}
    staged = model._staged_pq[1] if pq else model._staged_index[1]
    rec["l_pad"], rec["nlist_pad"] = staged.l_pad, staged.nlist_pad
    # one sweep block's query rows, and the rows of one scoring launch
    tile = pq_mod.pq_tile_bytes(staged, ANN_NPROBE) if pq else ivf.flat_tile_bytes(staged, ANN_NPROBE)
    rec["block_rows"], rec["scan_rows"] = ivf.sweep_geometry(ANN_QUERIES, ANN_NPROBE * staged.l_pad, tile)
    rec["merge_vs_lex_topk"] = ann_merge_check(torch, ivf, pq_mod, knn_ops, kk, staged, Q, pq_k(params), pq, dev)
    # checks on ANN_CHECK_QUERIES queries, outside the counted window
    i_c, d_c = ann_rows(model, check_df)
    model.setExactSearch(True)
    i_ex, _ = ann_rows(model, check_df)
    model.setExactSearch(False)
    rec["recall_at_10"] = ivf.recall_at_k(i_c[:, :10], i_ex[:, :10])
    rec["recall_at_200"] = ivf.recall_at_k(i_c, i_ex)
    rec["recall_at_10_of_the_timed_call"] = ivf.recall_at_k(idx[:ANN_CHECK_QUERIES, :10], i_ex[:, :10])
    check(rec["recall_at_10"] >= gate, f"recall@10 {rec['recall_at_10']} < {gate}")
    if pq:
        model.setAlgoParams(dict(params, refine_ratio=1))
        i_raw, _ = ann_rows(model, check_df)
        model.setAlgoParams(params)
        rec["adc_recall_at_10"] = ivf.recall_at_k(i_raw[:, :10], i_ex[:, :10])
        rec["adc_recall_at_200"] = ivf.recall_at_k(i_raw, i_ex)
    model.save(model_dir)
    i_l, d_l = ann_rows(port.load(model_dir), check_df)
    check(np.array_equal(i_l, i_c) and np.array_equal(d_l.view(np.uint32), d_c.view(np.uint32)),
          "the reloaded model gives other results")
    rec["reloaded_identical"] = True
    if fast:
        model.setAlgoParams(dict(params, hot_fraction=ANN_HOT_FRACTION))
        t0 = time.perf_counter()
        i_t, d_t = ann_rows(model, check_df)
        rec["tiered_s"] = time.perf_counter() - t0
        rec["tier"] = model._staged_pq[1].tier.stats()
        model.setAlgoParams(params)
        check(np.array_equal(i_t, i_c) and np.array_equal(d_t.view(np.uint32), d_c.view(np.uint32)),
              "the tiered search differs from the resident one")
        check(rec["tier"]["misses"] > 0 and rec["tier"]["page_bytes"] > 0, f"the tier paged nothing: {rec['tier']}")
        rec["tiered_identical"] = True
    if keep is not None:
        keep[phase] = model
        # path_ann_mesh holds the 4-shard search of the profiled call's
        # queries against the profiled (one-shard) results
        keep[f"{phase}_mesh_ref"] = {"rows": profiled["rows"], "exact_ids": i_ex, "profile": profile,
                                     "kneighbors_rows_per_s": ANN_QUERIES / kneighbors_s,
                                     "max_memory_allocated_bytes": peak_bytes}
    return {
        "phase": phase, "items": ANN_ITEMS, "cols": ANN_COLS, "queries": ANN_QUERIES, "k": ANN_K,
        "algorithm": algorithm, "algo_params": params, "rows_cut": True,
        "fit_s": fit_s, "first_kneighbors_s": first_s, "kneighbors_s": kneighbors_s,
        "stage_s": first_s - kneighbors_s, "kneighbors_rows_per_s": ANN_QUERIES / kneighbors_s,
        "launches_fit": launches_fit, "launches": launches, "max_memory_allocated_bytes": peak_bytes,
        "check_queries": ANN_CHECK_QUERIES, "recall_gate": gate, **rec, "profile": profile,
    }


def pq_k(params):
    """Candidates the probe merge keeps: k, times refine_ratio when > 1."""
    ratio = params.get("refine_ratio", 1)
    return ANN_K * ratio if ratio > 1 else ANN_K


# ---------------------------------------------------------------------------
# PCA, LinearRegression and LogisticRegression: no kernel of the port's own
# (cuBLAS and cuSOLVER through torch, TF32 off)
# ---------------------------------------------------------------------------

# The reference benchmark's configurations (databricks/run_benchmark.sh as
# SURVEY.md section 6 cites it), with data as bench.py makes it:
# PCA k = 3 on 1,000,000 x 3000 float32 low-rank rows (rank 32 plus 0.1
# noise, bench.py:196-201; run_benchmark.sh:57-64); LinearRegression OLS,
# ridge (regParam 1e-5, maxIter 10) and elastic net (regParam 1e-5,
# elasticNetParam 0.5, maxIter 10) (:66-99) and LogisticRegression
# (regParam 1e-5, maxIter 200; :125-133) on 1,000,000 x 3000 Gaussian X
# with y = X . coef + 0.1 noise, binary y > 0 (bench.py:226-232), 100,000
# more rows held out; the sparse multinomial arm (bench.py:259-301, the
# BASELINE.json shape at one card's scale): 4,000,000 x 100 CSR, one
# nonzero a row, 4 classes, regParam 1e-5, maxIter 100, tol 1e-6.  Not cut.
GLM_ROWS, GLM_HOLDOUT, GLM_COLS, GLM_PARTITIONS, GLM_SEED = 1_000_000, 100_000, 3000, 8, 42
PCA_K, PCA_RANK, PCA_SEED = 3, 32, 11
LINREG_FITS = {
    "ols": {},
    "ridge": dict(regParam=1e-5, maxIter=10),
    "elastic_net": dict(regParam=1e-5, elasticNetParam=0.5, maxIter=10),
}
LOGREG = dict(regParam=1e-5, maxIter=200)
SPARSE_ROWS, SPARSE_COLS, SPARSE_CLASSES, SPARSE_SEED = 4_000_000, 100, 4, 5
SPARSE_LOGREG = dict(regParam=1e-5, maxIter=100, tol=1e-6)
# PCA against the float64 covariance and float64 eigh of the same rows on
# the card: the JAX package's PCA test gates (tests/test_pca.py:40-48),
# component signs equal; the transform against float64 projections of
# 4,096 rows, max |error| over max |projection|
PCA_MEAN_ATOL, PCA_COMP_ATOL, PCA_RATIO_ATOL, PCA_SV_RTOL, PCA_PROJ_RTOL = 1e-4, 1e-3, 1e-4, 1e-3, 1e-5
# OLS and ridge against a float64 solve of the float64 normal equations
# (centred, standardised, ridge's alpha * n) on the card: max |coef -
# coef64| (and |intercept error|) over max |coef64|; the port's solve_linear
# on the float64 statistics against the same solve (ridge shrinks the
# coefficients by ~1e-5 relative, so this is where its alpha scaling shows)
LINREG_RTOL, LINREG_F64_RTOL = 1e-5, 1e-9
# elastic net against the port's CD run on the CPU from the card's float32
# statistics, max |error| over max |coef|; sweep counts equal
ENET_RTOL = 1e-5
HOLDOUT_R2, HOLDOUT_ACCURACY = 0.99, 0.9
# X^T X of 256 rows on the card against float64: max |error| over the
# product of absolute values, entry by entry (fp32 FMA sums stay under ~1e-6;
# TF32 products, 10 mantissa bits, leave ~1e-4)
TF32_PROBE_ROWS, TF32_PROBE_RTOL = 256, 5e-6
# glm_card_vs_cpu: 65,536 x 256, the same fits on the card and under
# use_device("cpu"): PCA components within 1e-4 (signs equal), linear
# coefficients within 1e-5 of max |coef| (CD sweeps equal), logistic
# coefficients within 1e-3 of max(1, max |W|) (regParam 1e-3, tol 1e-6, so
# both reach the same optimum)
CVC_ROWS, CVC_COLS, CVC_SEED = 65536, 256, 77
CVC_PCA_ATOL, CVC_LINEAR_RTOL, CVC_LOGISTIC_ATOL = 1e-4, 1e-5, 1e-3
GLM_PHASES = ("path_pca", "path_linreg", "path_logreg", "path_logreg_sparse", "glm_card_vs_cpu")


def low_rank_data(rows, cols, rank, seed, workers=8, part=None):
    """bench.py's PCA rows: A @ B + 0.1 noise with A (rows, rank), B (rank,
    cols) and the noise standard normal float32, filled by `workers`
    threads with independent seeded streams; `part` (lo, hi) makes only
    those rows (stream_rows)."""
    B = np.random.default_rng(seed).standard_normal((rank, cols), dtype=np.float32)

    def fill_chunk(rng_i, out, a, b):
        rng_i.standard_normal(out=out, dtype=np.float32)
        out *= 0.1
        out += rng_i.standard_normal((b - a, rank), dtype=np.float32) @ B

    return stream_rows(rows, cols, seed + 1, workers, fill_chunk, part)


def glm_data():
    """bench.py's GLM rows: standard normal X (GLM_ROWS + GLM_HOLDOUT rows),
    coef standard normal, y = X . coef + 0.1 noise, float32."""
    X = normal_data(GLM_ROWS + GLM_HOLDOUT, GLM_COLS, GLM_SEED)
    rng = np.random.default_rng(GLM_SEED + 1)
    coef = rng.standard_normal(GLM_COLS, dtype=np.float32)
    y = X @ coef + np.float32(0.1) * rng.standard_normal(len(X), dtype=np.float32)
    return X, y.astype(np.float32)


def f64_moments(torch, X, dev, y=None, chunk=65536):
    """(n, sum x, X^T X[, sum y, X^T y, sum y^2]) of the host rows in float64
    on the card, a chunk of rows at a time."""
    d = X.shape[1]
    sx = torch.zeros(d, dtype=torch.float64, device=dev)
    G = torch.zeros((d, d), dtype=torch.float64, device=dev)
    sy = torch.zeros((), dtype=torch.float64, device=dev)
    c = torch.zeros(d, dtype=torch.float64, device=dev)
    y2 = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, len(X), chunk):
        xb = torch.from_numpy(X[lo : lo + chunk]).to(dev).double()
        sx += xb.sum(dim=0)
        G.addmm_(xb.T, xb)
        if y is not None:
            yb = torch.from_numpy(y[lo : lo + chunk]).to(dev).double()
            sy += yb.sum()
            c.addmv_(xb.T, yb)
            y2 += (yb * yb).sum()
        del xb
    return float(len(X)), sx, G, sy, c, y2


def tf32_probe(torch, X, dev):
    """max |X^T X (float32, card) - float64| / (|X|^T |X|) over the entries,
    for the first TF32_PROBE_ROWS rows."""
    xb = torch.from_numpy(X[:TF32_PROBE_ROWS]).to(dev)
    got = (xb.T @ xb).double()
    x64 = xb.double()
    err = (got - x64.T @ x64).abs() / (x64.abs().T @ x64.abs()).clamp_min(1e-30)
    return float(err.max())


def precision_record(torch, X, dev):
    """The card's matmul precision settings after a fit, and the probe."""
    rec = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "tf32_probe_rel_err": tf32_probe(torch, X, dev)}
    check(rec["allow_tf32"] is False and rec["float32_matmul_precision"] == "highest",
          f"TF32 is on after the fit: {rec}")
    check(rec["tf32_probe_rel_err"] <= TF32_PROBE_RTOL,
          f"X^T X is not exact float32 on the card: {rec['tf32_probe_rel_err']} > {TF32_PROBE_RTOL}")
    return rec


def concat_col(df, name):
    return np.concatenate([np.asarray(p[name]) for p in df.partitions])


def round_trip(port, model, df, phase, cols):
    """transform -> save -> load -> transform: (the first outputs, seconds of
    the first transform); raises unless the reloaded model's outputs are
    identical."""
    model_dir = os.path.join(REPO, "build", f"chip_smoke_{phase}")
    shutil.rmtree(model_dir, ignore_errors=True)
    t0 = time.perf_counter()
    out = model.transform(df)
    seconds = time.perf_counter() - t0
    first = {c: concat_col(out, c) for c in cols}
    model.save(model_dir)
    out2 = port.load(model_dir).transform(df)
    for c in cols:
        check(np.array_equal(first[c], concat_col(out2, c)), f"{phase}: the reloaded model gives another {c}")
    return first, seconds


def timed_fit(torch, est, df, wrappers):
    """(model, fit seconds, peak device bytes over the bytes allocated
    before the fit, launches of the port's kernels)."""
    cold(lambda: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return model, seconds, torch.cuda.max_memory_allocated() - base, read_launches(wrappers)


def synced(torch, fn):
    """(fn(), seconds to its end on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pca_reference(torch, X, dev, k):
    """The float64 covariance and float64 eigh of the rows on the card:
    (mean, components with the sign rule, variance ratio, singular values)."""
    n, sx, G, *_ = f64_moments(torch, X, dev)
    mean = sx / n
    cov = (G - n * torch.outer(mean, mean)) / (n - 1.0)
    evals, evecs = torch.linalg.eigh((cov + cov.T) * 0.5)
    evals, comps = evals.flip(0), evecs.flip(1).T
    comps = comps[:k]
    comps = comps * torch.sign(comps.gather(1, comps.abs().argmax(dim=1, keepdim=True)))
    top = evals[:k]
    return (mean.cpu().numpy(), comps.cpu().numpy(), (top / evals.sum()).cpu().numpy(),
            torch.sqrt(top * (n - 1.0)).cpu().numpy())


def run_pca_path(torch, port, wrappers, dev, X, gen_s, keep=None):
    """Phase path_pca: PCA(k=3) on the low-rank rows X (made in gen_s
    seconds) through the public API, fit -> transform -> save -> load ->
    transform, against the float64 covariance and eigh of the same rows;
    stage times and a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import linalg

    df = port.DataFrame.from_numpy(X, num_partitions=GLM_PARTITIONS)
    est = port.PCA(k=PCA_K)
    model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    precision = precision_record(torch, X, dev)
    outs, transform_s = round_trip(port, model, df, "path_pca", ["pca_features"])
    proj = outs["pca_features"]
    check(proj.shape == (GLM_ROWS, PCA_K) and np.isfinite(proj).all(), f"projections {proj.shape}")

    (mean, comps, ratio, sv), ref_s = synced(torch, lambda: pca_reference(torch, X, dev, PCA_K))
    errs = {
        "mean_max_abs_err": float(np.abs(model.mean_ - mean).max()),
        "components_max_abs_err": float(np.abs(model.components_ - comps).max()),
        "ratio_max_abs_err": float(np.abs(model.explained_variance_ratio_ - ratio).max()),
        "singular_values_max_rel_err": float(np.abs(model.singular_values_ / sv - 1.0).max()),
    }
    check(np.array_equal(np.sign(model.components_[np.arange(PCA_K), np.abs(comps).argmax(axis=1)]),
                         np.sign(comps[np.arange(PCA_K), np.abs(comps).argmax(axis=1)])), "component signs differ")
    check(errs["mean_max_abs_err"] <= PCA_MEAN_ATOL and errs["components_max_abs_err"] <= PCA_COMP_ATOL
          and errs["ratio_max_abs_err"] <= PCA_RATIO_ATOL and errs["singular_values_max_rel_err"] <= PCA_SV_RTOL,
          f"PCA against float64: {errs}")
    want = X[:4096].astype(np.float64) @ model.components_.T
    errs["transform_max_rel_err"] = float(np.abs(proj[:4096] - want).max() / np.abs(want).max())
    check(errs["transform_max_rel_err"] <= PCA_PROJ_RTOL, f"projections against float64: {errs}")

    inputs, ingest_s = synced(torch, lambda: cold(lambda: est._build_fit_inputs(df)))
    (wsum, mean_t, scatter), moments_s = synced(torch, lambda: linalg.weighted_moments(inputs.X, inputs.weight))
    del inputs
    cov, cov_s = synced(torch, lambda: linalg.covariance(wsum, mean_t, scatter))
    _, eigh_s = synced(torch, lambda: linalg.eigh_descending(cov))
    profile = profile_run(torch, lambda: cold(lambda: est.fit(df)), ("core.ingest", "pca.fit"), wrappers)
    del df, cov, scatter
    if keep is not None:
        keep["path_pca"] = model
        keep["path_pca_reference"] = (mean, comps, ratio, sv)
    return {
        "phase": "path_pca", "rows": GLM_ROWS, "cols": GLM_COLS, "k": PCA_K, "rank": PCA_RANK,
        "partitions": GLM_PARTITIONS, "data_gen_s": gen_s,
        "fit_s": fit_s, "transform_s": transform_s, "transform_rows_per_s": GLM_ROWS / transform_s,
        "max_memory_allocated_bytes": peak, "launches": launches, "precision": precision,
        "explained_variance_ratio": model.explained_variance_ratio_.tolist(),
        "gates": {"mean_atol": PCA_MEAN_ATOL, "components_atol": PCA_COMP_ATOL, "ratio_atol": PCA_RATIO_ATOL,
                  "singular_values_rtol": PCA_SV_RTOL, "transform_rtol": PCA_PROJ_RTOL},
        "errors_vs_float64": errs, "float64_reference_s": ref_s, "reloaded_identical": True,
        "stages_s": {"ingest": ingest_s, "moments": moments_s, "covariance": cov_s, "eigh_float64": eigh_s},
        "moments_bound_s": 2.0 * GLM_ROWS * GLM_COLS ** 2 / PEAK_FP32_FLOPS,
        "profile": profile,
    }


def f64_linear_solve(torch, stats64, alpha, fit_intercept=True, standardize=True):
    """The float64 reference of OLS / Spark ridge, written apart from the
    port: centred normal equations, features scaled to unit variance,
    (G + alpha n I) b = c, no jitter.  (coef, intercept) on the card."""
    n, sx, G, sy, c, _ = stats64
    xm, ym = sx / n, sy / n
    if fit_intercept:
        G = G - n * torch.outer(xm, xm)
        c = c - n * xm * ym
    s = torch.sqrt(torch.diagonal(G) / n) if standardize else torch.ones_like(xm)
    s = torch.where(s > 0, s, torch.ones_like(s))
    A = G / torch.outer(s, s) + alpha * n * torch.eye(len(s), dtype=G.dtype, device=G.device)
    b = torch.linalg.solve(A, c / s) / s
    return b, (ym - xm @ b) if fit_intercept else torch.zeros((), dtype=b.dtype, device=b.device)


def cd_sweep_times(torch, glm, stats, params, dev):
    """One elastic-net CD sweep on the card's statistics, run eagerly and as
    the replay of its captured CUDA graph (ms), and the capture's cost."""
    system, _ = glm._cd_system(stats, float(params["alpha"]), float(params["l1_ratio"]),
                               bool(params["fit_intercept"]), bool(params["normalize"]))
    b = torch.zeros(system[0].shape[0], dtype=system[0].dtype, device=dev)
    md = torch.zeros((), dtype=system[0].dtype, device=dev)
    eager = [synced(torch, lambda: glm._cd_sweep(*system, b, md))[1] for _ in range(2)]
    run, capture_s = synced(torch, lambda: glm._sweep_runner(functools.partial(glm._cd_sweep, *system, b, md), dev))
    replays = [synced(torch, run)[1] for _ in range(3)]
    return {"eager_sweep_ms": [1e3 * t for t in eager], "graph_sweep_ms": [1e3 * t for t in replays],
            "graph_warmup_and_capture_ms": 1e3 * capture_s, "coordinates": int(system[0].shape[0])}


def run_linreg_path(torch, port, wrappers, X, y, dev, keep=None):
    """Phase path_linreg: OLS, ridge and elastic net from one frame through
    the public API, each fit -> transform -> save -> load -> transform with
    held-out R^2; OLS and ridge against a float64 solve of the float64
    normal equations, elastic net against the port's CD on the CPU from the
    card's statistics; stage times, CD sweeps eager and as a CUDA graph, and
    a profiled ridge fit."""
    from spark_rapids_ml_tpu_torch.ops import glm

    df = port.DataFrame.from_numpy(X[:GLM_ROWS], y[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    y_hold = y[GLM_ROWS:].astype(np.float64)
    stats64, ref_s = synced(torch, lambda: f64_moments(torch, X[:GLM_ROWS], dev, y[:GLM_ROWS]))
    n, sx, G64, sy, c64, y2 = stats64
    stats64_port = glm.LinregStats(torch.tensor(n, dtype=torch.float64, device=dev), sx / n, sy / n, G64, c64, y2)

    est0 = port.LinearRegression()
    inputs, ingest_s = synced(torch, lambda: cold(lambda: est0._build_fit_inputs(df)))
    stats32, stats_s = synced(torch, lambda: glm.linreg_sufficient_stats(inputs.X, inputs.y, inputs.weight))
    del inputs
    fits, precision = {}, None
    for name, params in LINREG_FITS.items():
        est = port.LinearRegression(**params)
        port.profiling.reset_counters("glm.")
        model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
        if precision is None:
            precision = precision_record(torch, X, dev)
        outs, transform_s = round_trip(port, model, df, f"path_linreg_{name}", ["prediction"])
        check(np.isfinite(outs["prediction"]).all(), f"{name}: non-finite predictions")
        hold_pred = concat_col(model.transform(hold), "prediction")
        r2 = float(1.0 - ((hold_pred - y_hold) ** 2).mean() / y_hold.var())
        check(r2 > HOLDOUT_R2, f"{name}: held-out R^2 {r2} <= {HOLDOUT_R2}")
        tp = dict(est._tpu_params)
        rec = {"params": params, "fit_s": fit_s, "transform_s": transform_s,
               "transform_rows_per_s": GLM_ROWS / transform_s, "max_memory_allocated_bytes": peak,
               "launches": launches, "holdout_r2": r2, "reloaded_identical": True}
        if name in ("ols", "ridge"):
            alpha = float(tp["alpha"])
            b64, b0_64 = f64_linear_solve(torch, stats64, alpha)
            scale = float(b64.abs().max())
            b64_h, b0_h = b64.cpu().numpy(), float(b0_64)
            rec["coef_max_rel_err_vs_float64"] = float(np.abs(model.coef_ - b64_h).max()) / scale
            rec["intercept_rel_err_vs_float64"] = abs(model.intercept_ - b0_h) / scale
            pb, pb0 = glm.solve_linear(stats64_port, alpha, fit_intercept=True, normalize=True)
            rec["port_solve_float64_max_rel_err"] = float((pb - b64).abs().max()) / scale
            check(rec["coef_max_rel_err_vs_float64"] <= LINREG_RTOL and rec["intercept_rel_err_vs_float64"] <= LINREG_RTOL,
                  f"{name} against the float64 solve: {rec}")
            check(rec["port_solve_float64_max_rel_err"] <= LINREG_F64_RTOL, f"{name}: the port's float64 solve: {rec}")
            if keep is not None and name == "ols":
                keep["path_linreg_float64"] = (b64_h, b0_h, scale)
            _, rec["solve_s"] = synced(torch, lambda: glm.solve_linear(stats32, alpha, True, True))
        else:
            sweeps = port.profiling.counters("glm.").get("glm.cd_sweeps")
            cpu_stats = glm.LinregStats(*(t.cpu() for t in stats32))
            (b_cpu, b0_cpu, it_cpu), cpu_s = synced(torch, lambda: glm.solve_elasticnet_cd(
                cpu_stats, float(tp["alpha"]), float(tp["l1_ratio"]), bool(tp["fit_intercept"]),
                bool(tp["normalize"]), int(tp["max_iter"]), float(tp["tol"])))
            scale = float(b_cpu.abs().max())
            rec.update(cd_sweeps=sweeps, cd_sweeps_cpu=it_cpu, cd_cpu_s=cpu_s,
                       coef_max_rel_err_vs_cpu_cd=float(np.abs(model.coef_ - b_cpu.numpy()).max()) / scale,
                       intercept_abs_err_vs_cpu_cd=abs(model.intercept_ - float(b0_cpu)))
            check(sweeps == it_cpu, f"CD sweeps: card {sweeps}, CPU {it_cpu}")
            check(rec["coef_max_rel_err_vs_cpu_cd"] <= ENET_RTOL, f"elastic net against the CPU's CD: {rec}")
            _, rec["cd_s"] = synced(torch, lambda: glm.solve_elasticnet_cd(
                stats32, float(tp["alpha"]), float(tp["l1_ratio"]), bool(tp["fit_intercept"]), bool(tp["normalize"]),
                int(tp["max_iter"]), float(tp["tol"])))
            rec["cd_sweep"] = cd_sweep_times(torch, glm, stats32, tp, dev)
        fits[name] = rec
        if keep is not None and name == "ols":
            keep["path_linreg"] = model
    profile = profile_run(torch, lambda: cold(lambda: port.LinearRegression(**LINREG_FITS["ridge"]).fit(df)),
                          ("core.ingest", "glm.stats", "glm.solve"), wrappers)
    del df, hold, stats64, stats64_port, G64
    return {
        "phase": "path_linreg", "rows": GLM_ROWS, "cols": GLM_COLS, "holdout_rows": GLM_HOLDOUT,
        "partitions": GLM_PARTITIONS, "fits": fits, "precision": precision,
        "gates": {"ols_ridge_rtol_vs_float64": LINREG_RTOL, "port_float64_solve_rtol": LINREG_F64_RTOL,
                  "elastic_net_rtol_vs_cpu_cd": ENET_RTOL, "holdout_r2_above": HOLDOUT_R2},
        "stages_s": {"ingest": ingest_s, "stats": stats_s, "float64_reference": ref_s},
        "stats_bound_s": 2.0 * GLM_ROWS * GLM_COLS ** 2 / PEAK_FP32_FLOPS,
        "profile_ridge": profile,
    }


def run_logreg_path(torch, port, wrappers, X, y, dev, keep=None):
    """Phase path_logreg: binary LogisticRegression(regParam=1e-5,
    maxIter=200) on y > 0 through the public API: fit -> transform -> save ->
    load -> transform, held-out accuracy, the L-BFGS counts, one dense
    objective evaluation timed against its bound, a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import logistic

    yb = (y > 0).astype(np.float32)
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], yb[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    est = port.LogisticRegression(**LOGREG)
    port.profiling.reset_counters("lbfgs.")
    model, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    solver = port.profiling.counters("lbfgs.")
    precision = precision_record(torch, X, dev)
    cols = ["prediction", "probability", "rawPrediction"]
    outs, transform_s = round_trip(port, model, df, "path_logreg", cols)
    check(all(np.isfinite(outs[c]).all() for c in cols), "non-finite outputs")
    acc = float((concat_col(model.transform(hold), "prediction") == yb[GLM_ROWS:]).mean())
    check(acc > HOLDOUT_ACCURACY, f"held-out accuracy {acc} <= {HOLDOUT_ACCURACY}")

    inputs, ingest_s = synced(torch, lambda: cold(lambda: est._build_fit_inputs(df)))
    theta = torch.as_tensor(np.concatenate([model.coef_.ravel(), model.intercept_]).astype(np.float32), device=dev)
    wsum = inputs.weight[0].sum()
    eval_ms = median_ms(torch, lambda: logistic._data_value_and_grad(
        theta, inputs.X[0], inputs.y[0], inputs.weight[0], wsum, 1, GLM_COLS, True), 5)
    del inputs
    eval_bound_ms = 1e3 * 2 * GLM_ROWS * GLM_COLS * 4 / PEAK_BYTES_PER_S  # X read twice
    profile = profile_run(torch, lambda: cold(lambda: est.fit(df)), ("core.ingest", "lbfgs.fit"), wrappers)
    del df, hold
    if keep is not None:
        keep["path_logreg"] = model
    return {
        "phase": "path_logreg", "rows": GLM_ROWS, "cols": GLM_COLS, "holdout_rows": GLM_HOLDOUT,
        "params": LOGREG, "fit_s": fit_s, "transform_s": transform_s,
        "transform_rows_per_s": GLM_ROWS / transform_s, "max_memory_allocated_bytes": peak,
        "launches": launches, "precision": precision,
        "lbfgs_iterations": solver.get("lbfgs.iterations"), "lbfgs_evaluations": solver.get("lbfgs.evaluations"),
        "converged": bool(solver.get("lbfgs.converged")), "num_iters": model.num_iters,
        "holdout_accuracy": acc, "holdout_accuracy_above": HOLDOUT_ACCURACY, "reloaded_identical": True,
        "stages_s": {"ingest": ingest_s, "lbfgs": fit_s - ingest_s},
        "evaluation_ms": eval_ms, "evaluation_bound_ms": eval_bound_ms,
        "profiled_lbfgs_ms_per_evaluation": profile["range_host_ms"]["lbfgs.fit"] / solver["lbfgs.evaluations"],
        "profile": profile,
    }


def sparse_glm_data():
    """bench.py's sparse multinomial rows: one (column, value) a row,
    standard normal values, labels the argmax of the row's value times a
    standard normal (cols, 4) weight row.  (CSR matrix, labels float32)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(SPARSE_SEED)
    idx = rng.integers(0, SPARSE_COLS, size=SPARSE_ROWS, dtype=np.int32)
    val = rng.standard_normal(SPARSE_ROWS, dtype=np.float32)
    W_true = rng.standard_normal((SPARSE_COLS, SPARSE_CLASSES), dtype=np.float32)
    y = (val[:, None] * W_true[idx]).argmax(axis=1).astype(np.float32)
    indptr = np.arange(SPARSE_ROWS + 1, dtype=np.int64)
    return sp.csr_matrix((val, idx.astype(np.int64), indptr), shape=(SPARSE_ROWS, SPARSE_COLS)), y


def run_logreg_sparse_path(torch, port, wrappers, dev):
    """Phase path_logreg_sparse: multinomial LogisticRegression on the CSR
    frame through the public API, twice: bit-identical coefficients, no
    dense (N, D) feature tensor on the card, accuracy above the majority
    share; transform; one objective evaluation timed; a profiled fit."""
    from spark_rapids_ml_tpu_torch.ops import logistic

    t0 = time.perf_counter()
    csr, y = sparse_glm_data()
    gen_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(csr, y, num_partitions=1)
    est = port.LogisticRegression(**SPARSE_LOGREG)
    port.profiling.reset_counters("lbfgs.")
    first, fit_s, peak, launches = timed_fit(torch, est, df, wrappers)
    solver = port.profiling.counters("lbfgs.")
    second, fit2_s, _, _ = timed_fit(torch, est, df, wrappers)
    check(np.array_equal(first.coef_, second.coef_) and np.array_equal(first.intercept_, second.intercept_),
          "two fits of the same sparse frame differ")
    dense_bytes = SPARSE_ROWS * SPARSE_COLS * 4
    check(peak < dense_bytes, f"the sparse fit peaked at {peak} bytes, not under the dense {dense_bytes}")
    t0 = time.perf_counter()
    pred = concat_col(first.transform(df), "prediction")
    transform_s = time.perf_counter() - t0
    acc = float((pred == y).mean())
    majority = float(np.bincount(y.astype(np.int64)).max() / len(y))
    check(acc > majority, f"accuracy {acc} <= majority share {majority}")

    inputs, ingest_s = synced(torch, lambda: cold(lambda: est._build_fit_inputs(df)))
    ell = inputs.X[0]
    y_enc = inputs.y[0].long()
    theta = torch.as_tensor(np.concatenate([first.coef_.ravel(), first.intercept_]).astype(np.float32), device=dev)
    wsum = inputs.weight[0].sum()
    eval_ms = median_ms(torch, lambda: logistic._data_value_and_grad(
        theta, ell, y_enc, inputs.weight[0], wsum, SPARSE_CLASSES, SPARSE_COLS, True), 5)
    # bytes the evaluation needs: the ELL pair and its transpose once, the
    # scores written and read back, labels and weights
    eval_bytes = ell.nbytes() + 2 * SPARSE_ROWS * SPARSE_CLASSES * 4 + SPARSE_ROWS * (8 + 4)
    ell_bytes = ell.nbytes()
    del inputs, ell
    profile = profile_run(torch, lambda: cold(lambda: est.fit(df)), ("core.ingest", "lbfgs.fit"), wrappers)
    del df, csr
    return {
        "phase": "path_logreg_sparse", "rows": SPARSE_ROWS, "cols": SPARSE_COLS, "classes": SPARSE_CLASSES,
        "nnz_per_row": 1, "params": SPARSE_LOGREG, "data_gen_s": gen_s,
        "fit_s": fit_s, "second_fit_s": fit2_s, "identical_fits": True,
        "transform_s": transform_s, "transform_rows_per_s": SPARSE_ROWS / transform_s,
        "max_memory_allocated_bytes": peak, "dense_feature_bytes": dense_bytes, "ell_bytes": ell_bytes,
        "launches": launches, "lbfgs_iterations": solver.get("lbfgs.iterations"),
        "lbfgs_evaluations": solver.get("lbfgs.evaluations"), "converged": bool(solver.get("lbfgs.converged")),
        "accuracy": acc, "majority_share": majority,
        "stages_s": {"ingest": ingest_s, "lbfgs": fit_s - ingest_s},
        "evaluation_ms": eval_ms, "evaluation_bound_ms": 1e3 * eval_bytes / PEAK_BYTES_PER_S,
        "profiled_lbfgs_ms_per_evaluation": profile["range_host_ms"]["lbfgs.fit"] / solver["lbfgs.evaluations"],
        "profile": profile,
    }


def glm_card_vs_cpu(torch, port):
    """Phase glm_card_vs_cpu: the same reduced fits on the card and under
    use_device("cpu"): PCA, OLS, ridge, elastic net, and logistic (binary
    and 4-class, dense and CSR)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(CVC_SEED)
    X = rng.standard_normal((CVC_ROWS, CVC_COLS), dtype=np.float32)
    coef = rng.standard_normal(CVC_COLS, dtype=np.float32)
    y = (X @ coef + np.float32(0.1) * rng.standard_normal(CVC_ROWS, dtype=np.float32)).astype(np.float32)
    W4 = rng.standard_normal((CVC_COLS, 4), dtype=np.float32) / np.float32(8.0)
    noisy = rng.standard_normal((CVC_ROWS, 4), dtype=np.float32)
    y2 = ((X @ W4[:, 0] + noisy[:, 0]) > 0).astype(np.float32)
    y4 = (X @ W4 + noisy).argmax(axis=1).astype(np.float32)
    S = sp.random(CVC_ROWS, CVC_COLS, density=0.05, format="csr", random_state=CVC_SEED, dtype=np.float32)
    S.data = rng.standard_normal(S.nnz, dtype=np.float32)
    s_logits = S @ (W4 * np.float32(8.0)) + noisy
    s2 = (s_logits[:, 0] > 0).astype(np.float32)
    s4 = s_logits.argmax(axis=1).astype(np.float32)
    X_pca = low_rank_data(CVC_ROWS, CVC_COLS, PCA_RANK, CVC_SEED)
    logistic_params = dict(regParam=1e-3, maxIter=200, tol=1e-6)
    cases = [
        ("pca", port.PCA(k=PCA_K), X_pca, None),
        *((name, port.LinearRegression(**params), X, y) for name, params in LINREG_FITS.items()),
        ("logistic_binary", port.LogisticRegression(**logistic_params), X, y2),
        ("logistic_4_class", port.LogisticRegression(**logistic_params), X, y4),
        ("logistic_binary_csr", port.LogisticRegression(**logistic_params), S, s2),
        ("logistic_4_class_csr", port.LogisticRegression(**logistic_params), S, s4),
    ]
    rows = []
    for name, est, feats, labels in cases:
        df = port.DataFrame.from_numpy(feats, labels, num_partitions=2)
        port.profiling.reset_counters()
        card, card_s = synced(torch, lambda: est.fit(df))
        card_counts = port.profiling.counters()
        port.profiling.reset_counters()
        with port.device.use_device("cpu"):
            t0 = time.perf_counter()
            cpu = est.fit(df)
            cpu_s = time.perf_counter() - t0
        cpu_counts = port.profiling.counters()
        rec = {"case": name, "card_fit_s": card_s, "cpu_fit_s": cpu_s}
        if name == "pca":
            a, b = card.components_, cpu.components_
            rec["max_abs_err"] = float(np.abs(a - b).max())
            check(np.array_equal(np.sign(a[np.arange(PCA_K), np.abs(b).argmax(axis=1)]), np.ones(PCA_K)),
                  "card PCA signs differ from the CPU's")
            check(rec["max_abs_err"] <= CVC_PCA_ATOL, f"card and CPU PCA differ: {rec}")
        elif name.startswith("logistic"):
            a = np.concatenate([card.coef_.ravel(), card.intercept_])
            b = np.concatenate([cpu.coef_.ravel(), cpu.intercept_])
            rec.update(max_abs_err=float(np.abs(a - b).max()), scale=float(max(1.0, np.abs(b).max())),
                       iterations_card=card.num_iters, iterations_cpu=cpu.num_iters)
            check(rec["max_abs_err"] <= CVC_LOGISTIC_ATOL * rec["scale"], f"card and CPU logistic differ: {rec}")
        else:
            scale = float(np.abs(cpu.coef_).max())
            rec["max_rel_err"] = float(max(np.abs(card.coef_ - cpu.coef_).max(),
                                           abs(card.intercept_ - cpu.intercept_)) / scale)
            rec["cd_sweeps"] = [card_counts.get("glm.cd_sweeps"), cpu_counts.get("glm.cd_sweeps")]
            check(rec["cd_sweeps"][0] == rec["cd_sweeps"][1], f"CD sweeps differ: {rec}")
            check(rec["max_rel_err"] <= CVC_LINEAR_RTOL, f"card and CPU linear fits differ: {rec}")
        rows.append(rec)
    return {"phase": "glm_card_vs_cpu", "rows": CVC_ROWS, "cols": CVC_COLS,
            "tolerances": {"pca_atol": CVC_PCA_ATOL, "linear_rtol": CVC_LINEAR_RTOL,
                           "logistic_atol": CVC_LOGISTIC_ATOL}, "cases": rows}

# ---------------------------------------------------------------------------
# Model selection: CrossValidator over the GLMs (the batched sweep), the
# forest and KMeans (the fold loop), Pipeline and persistence
# ---------------------------------------------------------------------------

# The GLM grid: regParam geomspace(1e-3, 1, 4) x elasticNetParam {0, 0.5}:
# 8 candidates, 4 closed-form and 4 coordinate-descent (linear), 4 L-BFGS
# and 4 OWL-QN (logistic); 3 folds, seed 7.  The repeat sweep's grid is the
# same shape shifted by 2x.
CV_FOLDS, CV_SEED = 3, 7
CV_REGS = tuple(float(v) for v in np.geomspace(1e-3, 1.0, 4))
CV_REGS_SHIFTED = tuple(float(v) for v in np.geomspace(2e-3, 2.0, 4))
CV_L1S = (0.0, 0.5)
CV_LOGREG = dict(maxIter=100)
# the forest CV: PERF.md's regressor rows, maxDepth {4, 6}
CV_RF = dict(numTrees=30, maxBins=128, featureSubsetStrategy="onethird", seed=1)
CV_RF_DEPTHS = (4, 6)
# a batched logistic lane against the solo fit on its fold's train rows
CV_LOGISTIC_ATOL, CV_ITER_SLACK = 5e-3, 2
# cv_card_vs_cpu: integer-valued rows (every sum exact in float32), its
# grids, KMeans' k grid, and the silhouette against float64 on the host
CV_SMALL_REGS, CV_SMALL_L1S = (0.01, 1.0), (0.0, 0.5)
CV_KMEANS_KS = (4, 8)
SILHOUETTE_RTOL = 1e-9
CV_PHASES = ("path_cv_linreg", "path_cv_logreg", "path_cv_rf", "cv_card_vs_cpu")


def cold(fn):
    """fn() after emptying the port's fit-input cache: the next ingest
    stages its frame anew (the phases time cold fits and cold ingests)."""
    from spark_rapids_ml_tpu_torch.core import clear_fit_cache

    clear_fit_cache()
    return fn()


def glm_grid(port, cls, regs, l1s=CV_L1S):
    return port.ParamGridBuilder().addGrid(cls.regParam, list(regs)).addGrid(cls.elasticNetParam, list(l1s)).build()


def timed_cv(torch, port, cv, df, wrappers, batched=True, clear=True):
    """(model, seconds, counters, launches, peak bytes over the bytes
    allocated before): one CrossValidator fit (from an empty fit-input cache
    unless clear is False), every counter and kernel launch counter reset
    just before it."""
    if clear:
        port.clear_fit_cache()
    port.profiling.reset_counters()
    reset_launches(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = cv._fit(df, batched=batched)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return model, seconds, port.profiling.counters(), read_launches(wrappers), torch.cuda.max_memory_allocated() - base


def cv_record(cv, model, seconds, counts, launches, peak):
    """The fields every CV record carries."""
    n = len(model.avgMetrics)
    return {
        "cv_fit_s": seconds, "candidates": n, "folds": cv.getNumFolds(), "candidates_per_s": n / seconds,
        "stages_s": dict(cv._last_fit_phase_times), "counters": counts, "launches": launches,
        "max_memory_allocated_bytes": peak, "avgMetrics": model.avgMetrics, "stdMetrics": model.stdMetrics,
    }


def coef_rel_err(a, b):
    """max |a - b| over max |b| of two coefficient arrays."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-30))


def run_cv_linreg_path(torch, port, wrappers, X, y, dev):
    """Phase path_cv_linreg: CrossValidator(LinearRegression) over the 8
    candidates and 3 folds of 1,000,000 x 3000 rows: the batched sweep
    (one staged dataset), its lanes against solo fits on fold 0's train
    frame, a repeat sweep with the shifted grid (no new CD graph), and the
    fold loop timed once."""
    LR = port.LinearRegression
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], y[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    est = LR(standardization=False)
    grid = glm_grid(port, LR, CV_REGS)
    eva = port.RegressionEvaluator(metricName="rmse")

    def make_cv(g):
        return port.CrossValidator(estimator=est, estimatorParamMaps=g, evaluator=eva, numFolds=CV_FOLDS,
                                   seed=CV_SEED, collectSubModels=True)

    cv = make_cv(grid)
    model, cv_s, counts, launches, peak = timed_cv(torch, port, cv, df, wrappers)
    rec = cv_record(cv, model, cv_s, counts, launches, peak)
    check(counts.get("ingest.staged") == 1, f"the batched CV staged {counts.get('ingest.staged')} datasets, not 1")
    check(all(np.isfinite(model.avgMetrics)), f"avgMetrics {model.avgMetrics}")
    best = int(np.argmin(model.avgMetrics))
    rec["best"] = {"index": best, "regParam": grid[best][LR.regParam], "elasticNetParam": grid[best][LR.elasticNetParam]}
    rec["ingest_staged"] = counts.get("ingest.staged", 0)
    # 0 when an earlier phase captured the graph of this shape
    rec["cd_graph_captures"] = counts.get("glm.cd_graph_captures", 0)
    rec["precision"] = precision_record(torch, X, dev)

    # the repeat sweep: another grid of the same shape, no new CD capture
    cv2 = make_cv(glm_grid(port, LR, CV_REGS_SHIFTED))
    model2, cv2_s, counts2, _, _ = timed_cv(torch, port, cv2, df, wrappers, clear=False)
    check(counts2.get("glm.cd_graph_captures", 0) == 0,
          f"the repeat sweep captured {counts2.get('glm.cd_graph_captures')} CD graphs")
    rec["repeat"] = {"cv_fit_s": cv2_s, "counters": counts2, "avgMetrics": model2.avgMetrics,
                     "cd_graph_captures": counts2.get("glm.cd_graph_captures", 0),
                     "stages_s": dict(cv2._last_fit_phase_times)}

    # fold 0's lanes against solo fits on fold 0's train frame: the best
    # lane and a coordinate-descent lane
    cd_lane = next(i for i, pm in enumerate(grid) if pm[LR.elasticNetParam] > 0 and i != best)
    train0 = cold(lambda: cv._kFold(df)[0][0])
    solo = {}
    for i in (best, cd_lane):
        fit = est.copy(grid[i]).fit(train0)
        lane = model.subModels[0][i]
        scale = float(np.abs(fit.coef_).max())
        solo[str(i)] = {"coef_max_rel_err": coef_rel_err(lane.coef_, fit.coef_),
                        "intercept_rel_err": abs(lane.intercept_ - fit.intercept_) / scale}
        check(solo[str(i)]["coef_max_rel_err"] <= LINREG_RTOL and solo[str(i)]["intercept_rel_err"] <= LINREG_RTOL,
              f"lane {i} of fold 0 against its solo fit: {solo[str(i)]}")
    rec["lanes_vs_solo_fold0"] = solo
    del train0

    # the fold loop at this size, timed once (no gate)
    cvs = make_cv(grid)
    model_s, seq_s, counts_s, _, _ = timed_cv(torch, port, cvs, df, wrappers, batched=False)
    rec["fold_loop"] = {
        "cv_fit_s": seq_s, "stages_s": dict(cvs._last_fit_phase_times), "counters": counts_s,
        "avgMetrics": model_s.avgMetrics, "best_index": int(np.argmin(model_s.avgMetrics)),
        "avgMetrics_max_rel_diff": float(np.max(np.abs(np.subtract(model_s.avgMetrics, model.avgMetrics))
                                                / np.abs(model.avgMetrics))),
        "coef_max_rel_err_vs_batched": max(coef_rel_err(a.coef_, b.coef_)
                                           for fa, fb in zip(model.subModels, model_s.subModels)
                                           for a, b in zip(fa, fb)),
    }
    port.clear_fit_cache()
    del df
    return {"phase": "path_cv_linreg", "rows": GLM_ROWS, "cols": GLM_COLS, "partitions": GLM_PARTITIONS,
            "grid": {"regParam": list(CV_REGS), "elasticNetParam": list(CV_L1S)}, "seed": CV_SEED,
            "gates": {"ingest_staged": 1, "lanes_vs_solo_rtol": LINREG_RTOL, "repeat_cd_graph_captures": 0}, **rec}


def run_cv_logreg_path(torch, port, wrappers, X, y, dev):
    """Phase path_cv_logreg: CrossValidator(LogisticRegression(maxIter=100))
    over the 8 candidates and 3 folds of 1,000,000 x 3000 rows, y > 0: the
    batched sweep's two families of 12 lanes (L-BFGS and OWL-QN), each
    family's iterations, evaluations and ms an evaluation against the byte
    bound, the best lane against its solo fit on fold 0, and a profiled
    sweep's idle share."""
    LG = port.LogisticRegression
    yb = (y > 0).astype(np.float32)
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], yb[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    est = LG(**CV_LOGREG)
    grid = glm_grid(port, LG, CV_REGS)
    eva = port.MulticlassClassificationEvaluator(metricName="accuracy")
    cv = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=CV_FOLDS,
                             seed=CV_SEED, collectSubModels=True)
    model, cv_s, counts, launches, peak = timed_cv(torch, port, cv, df, wrappers)
    rec = cv_record(cv, model, cv_s, counts, launches, peak)
    check(counts.get("ingest.staged") == 1, f"the batched CV staged {counts.get('ingest.staged')} datasets, not 1")
    best = int(np.argmax(model.avgMetrics))
    rec["best"] = {"index": best, "regParam": grid[best][LG.regParam], "elasticNetParam": grid[best][LG.elasticNetParam]}
    eval_bound_ms = 1e3 * 2 * GLM_ROWS * GLM_COLS * 4 / PEAK_BYTES_PER_S  # X read twice
    families = {}
    for fam in ("lbfgs", "owlqn"):
        evals = counts.get(f"tuning.sweep.{fam}.evaluations", 0)
        seconds = rec["stages_s"].get(f"tuning.sweep.solve.{fam}")
        families[fam] = {"lanes": CV_FOLDS * 4, "iterations": counts.get(f"tuning.sweep.{fam}.iterations"),
                         "evaluations": evals, "seconds": seconds,
                         "ms_per_evaluation": 1e3 * seconds / evals if evals else None,
                         "evaluation_bound_ms": eval_bound_ms}
    check(all(f["evaluations"] > 0 for f in families.values()), f"a penalty family did not run: {families}")
    rec["families"] = families
    rec["precision"] = precision_record(torch, X, dev)

    train0 = cold(lambda: cv._kFold(df)[0][0])
    fit = est.copy(grid[best]).fit(train0)
    lane = model.subModels[0][best]
    gate = {"coef_max_abs_err": float(np.abs(lane.coef_ - fit.coef_).max()),
            "intercept_abs_err": float(np.abs(lane.intercept_ - fit.intercept_).max()),
            "num_iters": [int(lane.num_iters), int(fit.num_iters)]}
    check(gate["coef_max_abs_err"] <= CV_LOGISTIC_ATOL and gate["intercept_abs_err"] <= CV_LOGISTIC_ATOL
          and abs(gate["num_iters"][0] - gate["num_iters"][1]) <= CV_ITER_SLACK,
          f"the best lane of fold 0 against its solo fit: {gate}")
    rec["best_lane_vs_solo_fold0"] = gate
    del train0

    # a profiled sweep, its dataset staged beforehand: the solver's idle share
    cold(lambda: est._build_fit_inputs(df))
    rec["profile_sweep"] = profile_run(
        torch, lambda: est._fitBatchedSweep(df, grid, CV_FOLDS, CV_SEED),
        ("tuning.sweep.ingest", "tuning.sweep.solve", "tuning.sweep.solve.lbfgs", "tuning.sweep.solve.owlqn"),
        wrappers)
    port.clear_fit_cache()
    del df
    return {"phase": "path_cv_logreg", "rows": GLM_ROWS, "cols": GLM_COLS, "partitions": GLM_PARTITIONS,
            "params": CV_LOGREG, "grid": {"regParam": list(CV_REGS), "elasticNetParam": list(CV_L1S)},
            "seed": CV_SEED, "gates": {"ingest_staged": 1, "lane_vs_solo_atol": CV_LOGISTIC_ATOL,
                                       "num_iters_slack": CV_ITER_SLACK}, **rec}


def forest_hist_launches(port, trees, depth, n_bins):
    """B3's launches by route of one regressor fit's shallow phase, as
    _hist_route sends them."""
    shapes = port.ops.forest_grow.shallow_launches(trees, 2, depth)
    routes = [port.ops.forest_hist._hist_route(tp, nodes, 2, n_bins) for _, nodes, tp in shapes]
    return {f"node_histograms_{r}": routes.count(r) for r in ("mma", "atomic")}


def run_cv_rf_path(torch, port, wrappers, X, y):
    """Phase path_cv_rf: CrossValidator(RandomForestRegressor(numTrees=30,
    "onethird")) over maxDepth {4, 6} and 3 folds of the RF rows: one
    binning (B2) a fold, B3's launches by route as _hist_route sends them
    for the 6 fits and the refit, and the combined transform-evaluate of
    fold 0 equal to each sub-model's own evaluate(transform)."""
    RFR = port.RandomForestRegressor
    df = port.DataFrame.from_numpy(X[:RF_ROWS], y[:RF_ROWS], num_partitions=RF_PARTITIONS)
    est = RFR(**CV_RF)
    grid = port.ParamGridBuilder().addGrid(RFR.maxDepth, list(CV_RF_DEPTHS)).build()
    eva = port.RegressionEvaluator(metricName="rmse")
    cv = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=CV_FOLDS,
                             seed=CV_SEED, collectSubModels=True)
    model, cv_s, counts, launches, peak = timed_cv(torch, port, cv, df, wrappers)
    rec = cv_record(cv, model, cv_s, counts, launches, peak)
    best_depth = int(model.bestModel.getOrDefault("maxDepth"))
    n_bins = CV_RF["maxBins"]
    want = {"bin_features_fm": CV_FOLDS + 1}
    for depth, times in [(d, CV_FOLDS) for d in CV_RF_DEPTHS] + [(best_depth, 1)]:
        for name, n in forest_hist_launches(port, CV_RF["numTrees"], depth, n_bins).items():
            want[name] = want.get(name, 0) + times * n
    for name, n in want.items():
        check(launches[name] == n, f"the forest CV launched {name} {launches[name]} times, not {n}")
    rec["launches_expected"] = want
    rec["best_max_depth"] = best_depth

    valid0 = cold(lambda: cv._kFold(df)[0][1])
    subs = model.subModels[0]
    t0 = time.perf_counter()
    fused = subs[0]._combine(subs)._transformEvaluate(valid0, eva)
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [eva.evaluate(m.transform(valid0)) for m in subs]
    single_s = time.perf_counter() - t0
    check(fused == single, f"the combined evaluation {fused} differs from the per-model one {single}")
    rec["fold0_combined_vs_per_model"] = {"combined": fused, "per_model": single, "identical": True,
                                          "combined_s": fused_s, "per_model_s": single_s}
    del valid0, df
    port.clear_fit_cache()
    return {"phase": "path_cv_rf", "rows": RF_ROWS, "cols": X.shape[1], "partitions": RF_PARTITIONS,
            "params": CV_RF, "grid": {"maxDepth": list(CV_RF_DEPTHS)}, "seed": CV_SEED, **rec}


def silhouette64(X, labels):
    """The squared-euclidean silhouette of the rows in float64, from the
    clusters' counts, sums and squared-norm sums (written apart from the
    port's metrics/clustering.py)."""
    X = np.asarray(X, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    ks = np.unique(labels)
    n = np.array([(labels == k).sum() for k in ks], np.float64)
    S = np.stack([X[labels == k].sum(axis=0) for k in ks])
    Om = np.array([(X[labels == k] ** 2).sum() for k in ks])
    pos = np.searchsorted(ks, labels)
    x2 = (X * X).sum(axis=1)
    XS = X @ S.T
    D = np.maximum(Om[None, :] / n[None, :] + x2[:, None] - 2.0 * XS / n[None, :], 0.0)
    rows = np.arange(len(X))
    own = n[pos]
    a = np.maximum((Om[pos] + own * x2 - 2.0 * XS[rows, pos]) / np.maximum(own - 1.0, 1.0), 0.0)
    D[rows, pos] = np.inf
    b = D.min(axis=1)
    s = np.where(own <= 1.0, 0.0, (b - a) / np.maximum(np.maximum(a, b), 1e-300))
    return float(s.mean())


def cv_card_vs_cpu(torch, port, wrappers):
    """Phase cv_card_vs_cpu, at 65,536 x 256: on integer-valued rows the
    batched sweep equals the fold loop on the card (linear coefficients and
    avgMetrics bit for bit; logistic avgMetrics exactly and coefficients to
    CV_LOGISTIC_ATOL, margin-separated labels); the card against
    use_device("cpu") within the CVC_* tolerances; a KMeans CV with
    ClusteringEvaluator (B1 in every scored transform) against a float64
    silhouette; Pipeline fit -> transform -> save -> load; CrossValidatorModel
    save -> load."""
    rng = np.random.default_rng(CVC_SEED)
    X = rng.integers(-3, 4, size=(CVC_ROWS * 3 // 2, CVC_COLS)).astype(np.float32)
    c = rng.integers(-1, 2, size=CVC_COLS).astype(np.float32)
    score = X @ c
    X = X[score != 0][:CVC_ROWS]
    score = score[score != 0][:CVC_ROWS]
    check(len(X) == CVC_ROWS, "too few margin-separated rows")
    y_lin = (score + rng.integers(-2, 3, size=CVC_ROWS)).astype(np.float32)
    y_cls = (score > 0).astype(np.float32)
    cases = {
        "linear": (port.LinearRegression(standardization=False), port.LinearRegression, y_lin,
                   port.RegressionEvaluator(metricName="rmse")),
        "logistic": (port.LogisticRegression(maxIter=100), port.LogisticRegression, y_cls,
                     port.MulticlassClassificationEvaluator(metricName="accuracy")),
    }
    rows, models = {}, {}
    for name, (est, cls, labels, eva) in cases.items():
        df = port.DataFrame.from_numpy(X, labels, num_partitions=2)
        grid = glm_grid(port, cls, CV_SMALL_REGS, CV_SMALL_L1S)

        def run(batched, device=None):
            cv = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=CV_FOLDS,
                                     seed=CV_SEED, collectSubModels=True)
            with port.device.use_device(device):
                return cold(lambda: cv._fit(df, batched=batched))

        (bat, bat_s), (seq, seq_s) = (synced(torch, lambda b=b: run(b)) for b in (True, False))
        t0 = time.perf_counter()
        cpu = run(True, "cpu")
        cpu_s = time.perf_counter() - t0
        pairs = [(a, b, s) for fa, fb, fs in zip(bat.subModels, seq.subModels, cpu.subModels)
                 for a, b, s in zip(fa, fb, fs)]
        rec = {"card_batched_s": bat_s, "card_fold_loop_s": seq_s, "cpu_batched_s": cpu_s,
               "avgMetrics": [bat.avgMetrics, seq.avgMetrics, cpu.avgMetrics]}
        check(bat.avgMetrics == seq.avgMetrics, f"{name}: batched avgMetrics {bat.avgMetrics} != {seq.avgMetrics}")
        if name == "linear":
            check(all(np.array_equal(a.coef_, b.coef_) and a.intercept_ == b.intercept_ for a, b, _ in pairs),
                  "linear: a batched sub-model differs from the fold loop's")
            rec["card_vs_cpu_coef_max_rel_err"] = max(
                max(coef_rel_err(a.coef_, s.coef_), abs(a.intercept_ - s.intercept_) / np.abs(s.coef_).max())
                for a, _, s in pairs)
            rec["card_vs_cpu_avgMetrics_max_rel_diff"] = float(
                np.max(np.abs(np.subtract(bat.avgMetrics, cpu.avgMetrics)) / np.abs(cpu.avgMetrics)))
            check(rec["card_vs_cpu_coef_max_rel_err"] <= CVC_LINEAR_RTOL
                  and rec["card_vs_cpu_avgMetrics_max_rel_diff"] <= CVC_LINEAR_RTOL, f"linear card vs CPU: {rec}")
        else:
            rec["batched_vs_fold_loop_coef_max_abs_err"] = max(float(np.abs(a.coef_ - b.coef_).max())
                                                               for a, b, _ in pairs)
            check(rec["batched_vs_fold_loop_coef_max_abs_err"] <= CV_LOGISTIC_ATOL, f"logistic batched: {rec}")
            rec["card_vs_cpu_coef_max_abs_err"] = max(float(np.abs(a.coef_ - s.coef_).max()) for a, _, s in pairs)
            scale = max(1.0, max(float(np.abs(s.coef_).max()) for _, _, s in pairs))
            check(rec["card_vs_cpu_coef_max_abs_err"] <= CVC_LOGISTIC_ATOL * scale, f"logistic card vs CPU: {rec}")
        rows[name], models[name] = rec, (bat, df)

    # a CrossValidatorModel through save -> load
    bat, df = models["linear"]
    model_dir = os.path.join(REPO, "build", "chip_smoke_cv_model")
    shutil.rmtree(model_dir, ignore_errors=True)
    bat.save(model_dir)
    loaded = port.load(model_dir)
    check(loaded.avgMetrics == bat.avgMetrics, "the reloaded CrossValidatorModel has other avgMetrics")
    check(np.array_equal(concat_col(bat.transform(df), "prediction"), concat_col(loaded.transform(df), "prediction")),
          "the reloaded CrossValidatorModel predicts otherwise")

    # KMeans CV: B1 in every scored transform, the silhouette against float64
    Xb = blobs(CVC_ROWS, CVC_COLS, max(CV_KMEANS_KS), CVC_SEED)
    kdf = port.DataFrame.from_numpy(Xb, num_partitions=2)
    kgrid = port.ParamGridBuilder().addGrid(port.KMeans.k, list(CV_KMEANS_KS)).build()
    kcv = port.CrossValidator(estimator=port.KMeans(maxIter=20, seed=1), estimatorParamMaps=kgrid,
                              evaluator=port.ClusteringEvaluator(), numFolds=CV_FOLDS, seed=CV_SEED,
                              collectSubModels=True)
    kmodel, k_s, _, k_launches, _ = timed_cv(torch, port, kcv, kdf, wrappers)
    folds = kdf.randomSplit([1.0] * CV_FOLDS, seed=CV_SEED)
    want = np.mean([[silhouette64(concat_col(valid, "features"), concat_col(m.transform(valid), "prediction"))
                     for m in subs] for valid, subs in zip(folds, kmodel.subModels)], axis=0)
    sil_err = float(np.max(np.abs(np.asarray(kmodel.avgMetrics) - want) / np.abs(want)))
    # one B1 launch a nonempty partition of every scored transform
    scored = len(CV_KMEANS_KS) * sum(1 for f in folds for p in f.partitions if len(p))
    check(sil_err <= SILHOUETTE_RTOL, f"silhouette against float64: {sil_err} > {SILHOUETTE_RTOL}")
    check(k_launches["min_dist_argmin"] >= scored,
          f"the KMeans CV launched min_dist_argmin {k_launches['min_dist_argmin']} times, under {scored}")
    rows["kmeans"] = {"cv_fit_s": k_s, "avgMetrics": kmodel.avgMetrics, "silhouette_float64": want.tolist(),
                      "silhouette_max_rel_err": sil_err, "launches": k_launches,
                      "scored_transform_partitions": scored, "best_k": int(kmodel.bestModel.getOrDefault("k"))}

    # Pipeline: PCA -> LogisticRegression, fit -> transform -> save -> load
    pipe = port.Pipeline([port.PCA(k=8).setInputCol("features").setOutputCol("pca_features"),
                          port.LogisticRegression(maxIter=50).setFeaturesCol("pca_features")])
    pdf = port.DataFrame.from_numpy(X, y_cls, num_partitions=2)
    pm = cold(lambda: pipe.fit(pdf))
    out = pm.transform(pdf)
    pipe_dir = os.path.join(REPO, "build", "chip_smoke_pipeline")
    shutil.rmtree(pipe_dir, ignore_errors=True)
    pm.save(pipe_dir)
    out2 = port.load(pipe_dir).transform(pdf)
    for col in ("pca_features", "prediction", "probability"):
        check(np.array_equal(concat_col(out, col), concat_col(out2, col)), f"the reloaded pipeline gives another {col}")
    acc = float((concat_col(out, "prediction") == y_cls).mean())
    check(acc > 0.5, f"pipeline accuracy {acc}")
    rows["pipeline"] = {"stages": ["PCA", "LogisticRegression"], "accuracy": acc, "reloaded_identical": True}
    port.clear_fit_cache()
    return {"phase": "cv_card_vs_cpu", "rows": CVC_ROWS, "cols": CVC_COLS,
            "grid": {"regParam": list(CV_SMALL_REGS), "elasticNetParam": list(CV_SMALL_L1S)},
            "tolerances": {"linear_rtol": CVC_LINEAR_RTOL, "logistic_atol": CVC_LOGISTIC_ATOL,
                           "batched_logistic_atol": CV_LOGISTIC_ATOL, "silhouette_rtol": SILHOUETTE_RTOL},
            "cases": rows}


# -- UMAP -----------------------------------------------------------------------
# path_umap: 1,000,000 x 128 float32 rows around 100 blobs (seed 1) and
# 100,000 held-out rows; UMAP(n_neighbors=15, n_components=2, n_epochs=200,
# random_state=1), spectral init.  Then a fit at the JAX package's bench arm
# (bench.py:589-603: 50,000 x 128 standard normal rows, seed 0, same params).
UMAP_ROWS, UMAP_HOLDOUT, UMAP_COLS, UMAP_BLOBS, UMAP_K = 1_000_000, 100_000, 128, 100, 15
UMAP_PARAMS = dict(n_neighbors=UMAP_K, n_components=2, n_epochs=200, random_state=1)
UMAP_PARTS, UMAP_HOLDOUT_PARTS = 8, 4
UMAP_BENCH_ROWS, UMAP_BENCH_SEED = 50_000, 0
# the JAX package's quality gates (tests/test_umap.py): inter-blob centroid
# distance over the intra-blob spread, trustworthiness at k = 10 on sampled
# rows (float64 on the card), held-out rows at their blob's fit centroid
UMAP_SEPARATION, UMAP_TRUST_MIN, UMAP_AGREE_MIN = 2.0, 0.85, 0.9
UMAP_TRUST_SAMPLE, UMAP_TRUST_K = 5000, 10
UMAP_RELOAD_ROWS = 20_000     # held-out rows transformed by the reloaded model
UMAP_PROFILE_EPOCHS = 10      # layout epochs under the profiler
UMAP_PROFILE_RANGES = ("umap.knn", "umap.graph", "umap.init", "umap.layout")
# umap_card_vs_cpu: 20,000 x 32 blob rows, one graph for both devices
UMAP_CVC_ROWS, UMAP_CVC_COLS, UMAP_CVC_EPOCHS = 20_000, 32, 200
UMAP_NORMAL_ULPS, UMAP_PRESERVATION_TOL = 4, 0.01
# operations of one firing draw (threefry-2x32: 20 rounds of an add, a
# rotate (two shifts and an or) and an xor, 5 key injections of 3 adds) and
# of one attraction or repulsion pair in two components (differences,
# squares, two powers, the quotient, clips and sums)
UMAP_HASH_OPS, UMAP_PAIR_OPS = 20 * 5 + 5 * 3, 24


def umap_hooks(port):
    """Record the graph and the layout a fit builds: wraps the fit's calls
    of umap_fit_embedding and build_head_layout_device.  Returns (captured,
    restore)."""
    from spark_rapids_ml_tpu_torch.models import umap as model_mod
    from spark_rapids_ml_tpu_torch.ops import umap as ops_mod

    captured = {}
    fit, build = model_mod.umap_fit_embedding, ops_mod.build_head_layout_device

    def fit_hook(ids, dists, **kwargs):
        captured["ids"], captured["dists"] = ids, dists
        return fit(ids, dists, **kwargs)

    def build_hook(*args, **kwargs):
        captured["layout"] = build(*args, **kwargs)
        return captured["layout"]

    model_mod.umap_fit_embedding, ops_mod.build_head_layout_device = fit_hook, build_hook

    def restore():
        model_mod.umap_fit_embedding, ops_mod.build_head_layout_device = fit, build

    return captured, restore


def umap_graph_check(torch, X, ids, dists, dev):
    """The fit's kNN graph against float64 brute force on KNN_SAMPLE rows
    (the gate of path_knn: distances within KNN_DIST_RTOL, sets off the
    KNN_TIE_RTOL band equal), the self slot apart: its expanded-form
    distance is a residual, not a distance.  Also every row's self slot:
    how many are > 0, the largest, and rows that miss themselves."""
    n, k = ids.shape
    rng = np.random.default_rng(SEED)
    sample = np.sort(rng.choice(n, KNN_SAMPLE, replace=False))
    Xd = torch.from_numpy(X).to(dev)
    q64 = Xd[torch.from_numpy(sample).to(dev)].double()
    qn = (q64 * q64).sum(dim=1)
    d2 = torch.empty((KNN_SAMPLE, n), dtype=torch.float64, device=dev)
    for lo in range(0, n, 50_000):
        x = Xd[lo : lo + 50_000].double()
        d2[:, lo : lo + 50_000] = (qn[:, None] - 2.0 * (q64 @ x.T)) + (x * x).sum(dim=1)[None, :]
    rows = torch.arange(KNN_SAMPLE, device=dev)
    sample_t = torch.from_numpy(sample).to(dev)
    d2[rows, sample_t] = 0.0
    d64 = d2.clamp_(min=0.0).sqrt_()
    true_d = torch.topk(d64, k, dim=1, largest=False, sorted=True).values
    kth = true_d[:, -1:]
    got_pos = torch.from_numpy(ids[sample]).to(dev)
    got_d = torch.from_numpy(dists[sample]).to(dev, torch.float64)
    got_d64 = d64.gather(1, got_pos)
    not_self = got_pos != sample_t[:, None]
    rel = ((got_d - got_d64).abs() / got_d64.clamp(min=1e-300))[not_self]
    dist_err = float(rel.max())
    below = (d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    got_below = (got_d64 < kth * (1 - KNN_TIE_RTOL)).sum(dim=1)
    unique = bool((torch.sort(got_pos, dim=1).values.diff(dim=1) > 0).all())
    worst_out = float((got_d64 / kth - 1).max())
    check(dist_err <= KNN_DIST_RTOL, f"UMAP graph distances off float64 by up to {dist_err} relative")
    check(unique, "a row of the UMAP graph lists an item twice")
    check(worst_out <= KNN_TIE_RTOL, f"a UMAP graph item lies {worst_out} relative beyond the k-th distance")
    check(bool((below == got_below).all()), f"{int((below != got_below).sum())} graph rows miss an item off the tie band")
    del d2, d64, Xd
    torch.cuda.empty_cache()
    self_slot = ids == np.arange(n)[:, None]
    self_d = dists[self_slot]
    return {"sample": KNN_SAMPLE, "dist_max_rel_err_off_self": dist_err, "dist_rtol": KNN_DIST_RTOL,
            "tie_rtol": KNN_TIE_RTOL, "rows_missing_self": int(n - self_slot.any(axis=1).sum()),
            "self_distances_positive": int((self_d > 0).sum()), "self_distance_max": float(self_d.max()),
            "self_in_column_0": int(self_slot[:, 0].sum())}


def blob_centroids(emb, labels, k):
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    cents = np.stack([np.bincount(labels, weights=emb[:, j], minlength=k) for j in range(emb.shape[1])], 1)
    return cents / counts[:, None]


def blob_gates(emb, labels, k):
    """The JAX package's cluster gate over k blobs: the mean inter-centroid
    distance against the mean distance of a row to its blob's centroid."""
    cents = blob_centroids(emb, labels, k)
    intra = float(np.mean(np.bincount(labels, weights=np.linalg.norm(emb - cents[labels], axis=1), minlength=k)
                          / np.bincount(labels, minlength=k)))
    diff = cents[:, None, :] - cents[None, :, :]
    pair = np.linalg.norm(diff, axis=2)[np.triu_indices(k, 1)]
    return intra, float(pair.mean()), cents


def trustworthiness64(torch, X, E, k, dev):
    """sklearn.manifold.trustworthiness in float64 on the card: each row's
    k embedding neighbours' ranks among its input-space neighbours."""
    n = X.shape[0]
    Xd = torch.from_numpy(X).to(dev, torch.float64)
    Ed = torch.from_numpy(np.ascontiguousarray(E)).to(dev, torch.float64)
    dx = torch.cdist(Xd, Xd, compute_mode="donot_use_mm_for_euclid_dist")
    dx.fill_diagonal_(float("inf"))
    order = dx.argsort(dim=1)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(1, n + 1, device=dev).expand(n, n).contiguous())
    de = torch.cdist(Ed, Ed, compute_mode="donot_use_mm_for_euclid_dist")
    de.fill_diagonal_(float("inf"))
    nn_e = torch.topk(de, k, dim=1, largest=False).indices
    t = float((ranks.gather(1, nn_e) - k).clamp(min=0).sum())
    del dx, order, ranks, de
    torch.cuda.empty_cache()
    return 1.0 - 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)) * t


def neighbor_preservation64(torch, X, E, k, dev):
    """Mean share of each row's k input-space neighbours among its k
    embedding neighbours (float64 on the card; self excluded)."""
    def knn(A):
        A = torch.from_numpy(np.ascontiguousarray(A)).to(dev, torch.float64)
        out = []
        for lo in range(0, A.shape[0], 4096):
            d = torch.cdist(A[lo : lo + 4096], A, compute_mode="donot_use_mm_for_euclid_dist")
            d[torch.arange(d.shape[0], device=dev), torch.arange(lo, lo + d.shape[0], device=dev)] = float("inf")
            out.append(torch.topk(d, k, dim=1, largest=False).indices)
        return torch.cat(out)

    hi, lo = knn(X), knn(E)
    hit = (hi[:, :, None] == lo[:, None, :]).any(dim=2).sum(dim=1).double() / k
    return float(hit.mean())


def umap_kernel_shapes(torch, kk, nc, knn_ops, dev, X_host, launch_q):
    """B5 and B7 at the self-join's launch shape (a query block of
    `launch_q` rows against the 1,000,000 staged rows, d = 128, m from
    _select_m, k = 15): exact against their plain versions on integer data,
    B7 bit for bit on the blob rows' pool, and timed on the blob rows
    (library_ms: matmul + a per-group topk in 4,096-query chunks; topk over
    the pool)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, d = X_host.shape
    m = knn_ops._scan_geometry(UMAP_K, n)[1]
    integer = knn_exact_case(torch, kk, nc, dev, gen, n, d, launch_q, m, UMAP_K, 0)
    torch.cuda.empty_cache()
    X = torch.from_numpy(X_host).to(dev)
    Q = X[:launch_q].contiguous()
    norm = (X * X).sum(dim=1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    inorm, qn = kk._masked_norms(norm, valid), (Q * Q).sum(dim=1)
    v, p = kk.knn_candidates(X, norm, valid, Q, m)
    pv, pp = kk.knn_candidates_plain(X, inorm, Q, qn, m)
    out, ref = kk.knn_fused_merge(v, p, UMAP_K), kk.knn_fused_merge_plain(v, p, UMAP_K)
    plain_route = kk.knn_fused_merge_plain(pv, pp, UMAP_K)
    torch.cuda.synchronize()
    mismatches = merge_mismatches(torch, out, ref)
    check(sum(mismatches) == 0, f"knn_fused_merge at the UMAP block differs from its plain version: {mismatches}")
    merge_err = float((out[0] - ref[0]).abs().max())
    pool_err = float((v - pv).abs().max())
    dist_err = float((out[0] - plain_route[0]).abs().max())
    # the merged distances off the self slot (a residual) against the plain
    # route's within the kNN gate
    off_self = out[1] != torch.arange(launch_q, device=dev, dtype=out[1].dtype)[:, None]
    rel = ((out[0] - plain_route[0]).abs() / plain_route[0].clamp(min=1e-30))[off_self]
    check(float(rel.max()) <= KNN_DIST_RTOL, f"UMAP block distances off the plain route's by {float(rel.max())}")
    del pv, pp, plain_route, ref
    P = v.shape[1] * v.shape[2]

    def library_pool():
        return [pool_library(torch, kk, X, Q[lo : lo + 4096], inorm, qn[lo : lo + 4096], m)
                for lo in range(0, launch_q, 4096)]

    b5 = timings(torch, lambda: kk.knn_candidates(X, norm, valid, Q, m),
                 lambda: kk.knn_candidates_plain(X, inorm, Q, qn, m), library_pool, 3)
    b5["bound_ms"], b5["bound_by"] = pool_bound(launch_q, n, d, m)
    b7 = timings(torch, lambda: kk.knn_fused_merge(v, p, UMAP_K), lambda: kk.knn_fused_merge_plain(v, p, UMAP_K),
                 lambda: torch.topk(v.view(launch_q, P), UMAP_K, dim=1), 20)
    b7["route"] = list(kk._merge_route(P, UMAP_K))
    b7["bound_ms"], b7["bound_by"] = merge_bound(launch_q, P, UMAP_K)
    del X, Q, v, p
    torch.cuda.empty_cache()
    shape = {"n": n, "d": d, "q": launch_q, "m": m, "k": UMAP_K, "ng": -(-n // kk.GROUP), "pool": P}
    return {"integer": integer,
            "knn_candidates": {**shape, **b5, "max_abs_err": pool_err},
            "knn_fused_merge": {**shape, **b7, "max_abs_err": merge_err,
                                "dist_max_abs_err_vs_plain_route": dist_err}}


def run_umap_path(torch, port, knn_ops, kk, nc, wrappers, dev, mesh_out=None):
    """Phase path_umap: the fit, its graph, layout and quality gates, the
    held-out transform, save -> load, a second fit bit for bit, B5 / B7 at
    the self-join's shapes, and the bench arm's fit.  With `mesh_out`,
    path_umap_mesh runs after the second fit, its record put there."""
    from spark_rapids_ml_tpu_torch.ops import umap as umap_ops

    t0 = time.perf_counter()
    X_all, labels_all = blobs(UMAP_ROWS + UMAP_HOLDOUT, UMAP_COLS, UMAP_BLOBS, SEED, labels=True)
    X, Xh = X_all[:UMAP_ROWS], X_all[UMAP_ROWS:]
    labels, labels_h = labels_all[:UMAP_ROWS], labels_all[UMAP_ROWS:]
    data_s = time.perf_counter() - t0
    df = port.DataFrame.from_numpy(X, num_partitions=UMAP_PARTS)
    hdf = port.DataFrame.from_numpy(Xh, num_partitions=UMAP_HOLDOUT_PARTS)
    est = port.UMAP(**UMAP_PARAMS)

    def fit():
        port.clear_fit_cache()
        port.profiling.reset_phase_times()
        port.profiling.reset_counters("umap.")
        reset_launches(wrappers)
        search = knn_ops.knn_search_prepared
        search.flagged_rows = search.rerun_rows = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = est.fit(df)
        torch.cuda.synchronize()
        return (model, time.perf_counter() - t, port.profiling.phase_times(), port.profiling.counters("umap."),
                read_launches(wrappers), torch.cuda.max_memory_allocated(),
                {"flagged_rows": search.flagged_rows, "rerun_rows": search.rerun_rows})

    captured, restore = umap_hooks(port)
    try:
        model, fit_s, phases, counts, launches, peak, flags = fit()
    finally:
        restore()
    for name in ("knn_candidates", "knn_fused_merge"):
        check(launches[name] > 0, f"the UMAP fit launched {name} no time")
    emb = model.embedding_
    check(emb.shape == (UMAP_ROWS, 2) and bool(np.isfinite(emb).all()), f"embedding {emb.shape} not finite")
    check(counts.get("umap.h2d_transfers") == 2, f"the fit uploaded {counts.get('umap.h2d_transfers')} arrays, not 2")
    check(counts.get("umap.layout.dispatches") == -(-UMAP_PARAMS["n_epochs"] // umap_ops.EPOCH_BLOCK),
          f"layout dispatches {counts.get('umap.layout.dispatches')}")
    ids, dists = captured["ids"], captured["dists"]
    tails, w = captured["layout"]
    P, n_pad = int(tails.shape[1]), int(tails.shape[0])
    edges = int((w > 0).sum())
    graph = umap_graph_check(torch, X, ids, dists, dev)
    emit({"phase": "path_umap_fit", "fit_s": fit_s, "phases": phases, "graph": graph, "P": P, "n_pad": n_pad})

    # the layout alone: ms an epoch and the card's idle share, profiled
    a, b = umap_ops.find_ab_params(1.0, 0.1)
    init = umap_ops._random_init(1, n_pad, 2, dev)

    def layout_epochs():
        umap_ops.optimize_layout(init, tails, w, UMAP_ROWS, a, b, UMAP_PROFILE_EPOCHS, 1.0, 1.0, 5, 1)

    layout_epochs()  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    layout_epochs()
    torch.cuda.synchronize()
    layout_epoch_ms = 1e3 * (time.perf_counter() - t) / UMAP_PROFILE_EPOCHS
    layout_profile = profile_once(torch, layout_epochs, ())
    layout_profile.pop("port_kernel_ms", None)
    # bound of one epoch: the layout's tails and weights read once, the
    # gathered embedding rows and the embedding read and written once
    # (bytes); the firing hash (UMAP_HASH_OPS integer operations a slot,
    # counted at the fp32 peak: the data sheet gives no int32 rate), the
    # attraction (UMAP_PAIR_OPS a slot) and the (256, n) repulsion
    # (UMAP_PAIR_OPS a pair)
    epoch_bytes = P * n_pad * (4 + 4 + 8) + 2 * 8 * n_pad
    epoch_ops = P * n_pad * (UMAP_HASH_OPS + UMAP_PAIR_OPS) + umap_ops.NEG_TABLE * n_pad * UMAP_PAIR_OPS
    layout_bound_ms, layout_bound_by = bound(epoch_bytes, epoch_ops)

    # quality: blobs apart, trustworthiness, held-out rows at their blob
    intra, inter, cents = blob_gates(emb, labels, UMAP_BLOBS)
    check(inter > UMAP_SEPARATION * intra, f"blob separation {inter} <= {UMAP_SEPARATION} x {intra}")
    rng = np.random.default_rng(SEED)
    sample = np.sort(rng.choice(UMAP_ROWS, UMAP_TRUST_SAMPLE, replace=False))
    trust = trustworthiness64(torch, X[sample], emb[sample], UMAP_TRUST_K, dev)
    check(trust > UMAP_TRUST_MIN, f"trustworthiness {trust} <= {UMAP_TRUST_MIN}")
    reset_launches(wrappers)
    t = time.perf_counter()
    out = model.transform(hdf)
    transform_s = time.perf_counter() - t
    transform_launches = read_launches(wrappers)
    emb_h = concat_col(out, "embedding")
    check(emb_h.shape == (UMAP_HOLDOUT, 2) and bool(np.isfinite(emb_h).all()), "held-out embedding not finite")
    # each blob's fit centroid, as the fit rows of the blob pick it
    fit_pick = np.argmin(((emb[:, None, :] - cents[None]) ** 2).sum(axis=2), axis=1)
    majority = np.array([np.bincount(fit_pick[labels == c], minlength=UMAP_BLOBS).argmax() for c in range(UMAP_BLOBS)])
    pick_h = np.argmin(((emb_h[:, None, :] - cents[None]) ** 2).sum(axis=2), axis=1)
    agree = float((pick_h == majority[labels_h]).mean())
    check(agree > UMAP_AGREE_MIN, f"held-out agreement {agree} <= {UMAP_AGREE_MIN}")

    # save -> load -> an equal transform; a second fit bit for bit
    umap_dir = os.path.join(REPO, "build", "chip_smoke_umap")
    shutil.rmtree(umap_dir, ignore_errors=True)
    model.save(umap_dir)
    small = port.DataFrame.from_numpy(Xh[:UMAP_RELOAD_ROWS], num_partitions=2)
    e1 = concat_col(model.transform(small), "embedding")
    e2 = concat_col(port.load(umap_dir).transform(small), "embedding")
    check(np.array_equal(e1, e2), "the reloaded model transforms otherwise")
    shutil.rmtree(umap_dir, ignore_errors=True)
    model2, fit2_s, phases2, _, launches2, _, _ = fit()
    check(np.array_equal(model2.embedding_, emb), "two fits differ")
    del model2, captured
    if mesh_out is not None:
        mesh_out["rec"] = umap_mesh_part(torch, port, wrappers, df, ids, dists, emb, phases)

    # B5 / B7 at the self-join's launch shape
    pool = -(-UMAP_ROWS // kk.GROUP) * knn_ops._scan_geometry(UMAP_K, UMAP_ROWS)[1]
    launch_q = min(UMAP_ROWS, knn_ops._block_rows(32768, UMAP_COLS, pool, UMAP_K))
    kernels = umap_kernel_shapes(torch, kk, nc, knn_ops, dev, X, launch_q)
    del model, out, X_all

    # the JAX package's bench arm
    Xb = normal_data(UMAP_BENCH_ROWS, UMAP_COLS, UMAP_BENCH_SEED)
    bdf = port.DataFrame.from_numpy(Xb, num_partitions=8)
    port.clear_fit_cache()
    port.profiling.reset_phase_times()
    t = time.perf_counter()
    bench_model = port.UMAP(**UMAP_PARAMS).fit(bdf)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t
    check(bool(np.isfinite(bench_model.embedding_).all()), "bench-arm embedding not finite")
    bench_phases = port.profiling.phase_times()
    port.clear_fit_cache()
    torch.cuda.empty_cache()
    return {
        "phase": "path_umap", "rows": UMAP_ROWS, "cols": UMAP_COLS, "blobs": UMAP_BLOBS, "params": UMAP_PARAMS,
        "data_s": data_s, "fit_s": fit_s, "fit2_s": fit2_s, "phases": phases, "phases_fit2": phases2,
        "counters": counts, "launches": launches, "launches_fit2": launches2, "knn_flags": flags,
        "max_memory_allocated_bytes": peak, "P": P, "n_pad": n_pad, "edges": edges,
        "graph": graph, "layout_epoch_ms": layout_epoch_ms,
        "layout_epoch_ms_in_fit": 1e3 * phases["umap.layout"] / UMAP_PARAMS["n_epochs"],
        "layout_bound_ms": layout_bound_ms, "layout_bound_by": layout_bound_by,
        "layout_profile": layout_profile, "separation": {"intra": intra, "inter": inter, "min_ratio": UMAP_SEPARATION},
        "trustworthiness": trust, "trust_sample": UMAP_TRUST_SAMPLE, "trust_k": UMAP_TRUST_K,
        "transform_rows": UMAP_HOLDOUT, "transform_s": transform_s, "transform_rows_per_s": UMAP_HOLDOUT / transform_s,
        "transform_launches": transform_launches, "holdout_agreement": agree, "reload_equal": True,
        "fits_bit_for_bit": True, "kernels": kernels,
        "bench_arm": {"rows": UMAP_BENCH_ROWS, "cols": UMAP_COLS, "fit_s": bench_s, "phases": bench_phases},
    }


def umap_card_vs_cpu(torch, port, knn_ops, dev):
    """Phase umap_card_vs_cpu: threefry draws at the layout's and the
    transform's shapes equal bit for bit on the card and the CPU (normal
    within UMAP_NORMAL_ULPS), the assembled layout from one graph equal
    (degrees, starts, P, each head's (tail, weight) set), and a fit on each
    device from that graph within UMAP_PRESERVATION_TOL of each other's k=15
    neighbour preservation."""
    from spark_rapids_ml_tpu_torch.ann.ivfflat import shape_bucket
    from spark_rapids_ml_tpu_torch.device import use_device
    from spark_rapids_ml_tpu_torch.ops import prng
    from spark_rapids_ml_tpu_torch.ops import umap as umap_ops
    from spark_rapids_ml_tpu_torch.parallel.mesh import padded_row_count

    cpu = torch.device("cpu")
    X, _ = blobs(UMAP_CVC_ROWS, UMAP_CVC_COLS, UMAP_BLOBS, SEED + 5, labels=True)
    Xd = torch.from_numpy(X).to(dev)
    dists, ids = knn_ops.knn_search_prepared(knn_ops.prepare_items(Xd, np.arange(UMAP_CVC_ROWS), dev), Xd, UMAP_K)
    n_pad = padded_row_count(UMAP_CVC_ROWS)

    # the assembled layout, from the same graph on each device
    def assemble(device):
        i = torch.from_numpy(ids).to(device)
        W = umap_ops._calibrated_weights(i, torch.from_numpy(dists).to(device), 1.0, 1.0)
        heads, tails, w2, valid, wmax = umap_ops._graph_edges(i, W)
        st, sw, starts, deg, q = umap_ops._edge_order(
            heads, tails, w2, valid, wmax, torch.tensor(float(UMAP_CVC_EPOCHS), device=device),
            umap_ops.DEGREE_QUANTILE, n_pad)
        tails_pad, w_pad = umap_ops.build_head_layout_device(i, W, n_pad, UMAP_CVC_EPOCHS)
        order = torch.argsort(tails_pad.long() * 2 + (w_pad > 0).long(), dim=1, stable=True)
        return {"W": W.cpu(), "starts": starts.cpu(), "deg": deg.cpu(), "P": int(tails_pad.shape[1]),
                "tails_sorted": tails_pad.gather(1, order).cpu(), "w_sorted": w_pad.gather(1, order).cpu()}

    card, host = assemble(dev), assemble(cpu)
    layout = {"P": [card["P"], host["P"]], "W_max_abs_err": float((card["W"] - host["W"]).abs().max()),
              "starts_equal": bool(torch.equal(card["starts"], host["starts"])),
              "degrees_equal": bool(torch.equal(card["deg"], host["deg"])),
              "head_sets_equal": bool(torch.equal(card["tails_sorted"], host["tails_sorted"])
                                      and torch.equal(card["w_sorted"], host["w_sorted"]))}
    check(layout["P"][0] == layout["P"][1] and layout["starts_equal"] and layout["degrees_equal"]
          and layout["head_sets_equal"], f"the layouts assembled on the card and the CPU differ: {layout}")

    # the draws at the layout's and the transform's shapes
    P, bucket = card["P"], shape_bucket(UMAP_CVC_ROWS, lo=64)
    draws = {}
    for e in (0, UMAP_CVC_EPOCHS - 1):
        key = prng.split(prng.fold_in(prng.prng_key(1), e))
        grid = umap_ops._layout_grid(P, n_pad, cpu)
        pairs = {
            "firing_uniform": lambda d: umap_ops._counter_uniform(key[0].to(d), grid.to(d)),
            "bits_layout": lambda d: prng.random_bits(key[0].to(d), (P, n_pad)),
            "uniform_layout": lambda d: prng.uniform(key[0].to(d), (P, n_pad)),
            "negative_table": lambda d: prng.randint(key[1].to(d), (umap_ops.NEG_TABLE,), 0,
                                                     torch.tensor(UMAP_CVC_ROWS, device=d)),
            "uniform_transform": lambda d: prng.uniform(key[0].to(d), (bucket, UMAP_K)),
            "randint_transform": lambda d: prng.randint(key[1].to(d), (bucket, UMAP_K, 5), 0, UMAP_CVC_ROWS),
            "random_init": lambda d: umap_ops._random_init(e + 1, n_pad, 2, d),
        }
        for name, draw in pairs.items():
            a, b = draw(dev).cpu(), draw(cpu)
            same = bool(torch.equal(a, b))
            draws.setdefault(name, []).append(same)
            check(same, f"{name} (epoch {e}) differs on the card")
        nrm_card, nrm_cpu = prng.normal(key[0].to(dev), (n_pad, 2)).cpu(), prng.normal(key[0], (n_pad, 2))
        ulps = int((nrm_card.view(torch.int32).long() - nrm_cpu.view(torch.int32).long()).abs().max())
        draws.setdefault("normal_max_ulps", []).append(ulps)
        check(ulps <= UMAP_NORMAL_ULPS, f"normal differs by {ulps} ulps")

    # a fit on each device from the one graph
    df = port.DataFrame.from_numpy(X, num_partitions=2)
    est = port.UMAP(n_neighbors=UMAP_K, n_epochs=UMAP_CVC_EPOCHS, random_state=1, precomputed_knn=(ids, dists))
    t = time.perf_counter()
    e_card = est.fit(df).embedding_
    card_s = time.perf_counter() - t
    with use_device("cpu"):
        t = time.perf_counter()
        e_cpu = est.fit(df).embedding_
        cpu_s = time.perf_counter() - t
    s_card = neighbor_preservation64(torch, X, e_card, UMAP_K, dev)
    s_cpu = neighbor_preservation64(torch, X, e_cpu, UMAP_K, dev)
    check(abs(s_card - s_cpu) < UMAP_PRESERVATION_TOL, f"neighbour preservation card {s_card} vs cpu {s_cpu}")
    port.clear_fit_cache()
    return {"phase": "umap_card_vs_cpu", "rows": UMAP_CVC_ROWS, "cols": UMAP_CVC_COLS, "n_epochs": UMAP_CVC_EPOCHS,
            "layout": layout, "draws": draws, "normal_ulps_max": UMAP_NORMAL_ULPS,
            "preservation": {"card": s_card, "cpu": s_cpu, "tol": UMAP_PRESERVATION_TOL},
            "embeddings_equal": bool(np.array_equal(e_card, e_cpu)), "fit_s": {"card": card_s, "cpu": cpu_s}}


UMAP_PHASES = ("path_umap", "umap_card_vs_cpu")


# ---------------------------------------------------------------------------
# Streaming (srml-stream): the four engines at the flagship configurations
# and the live IVF-Flat index on the ANN cell
# ---------------------------------------------------------------------------

# the JAX bench arm's chunk (bench.py:618) for the linear, PCA and KMeans
# engines; 65,536-row chunks for the logistic engine, whose L-BFGS host loop
# runs once a chunk (16 chunks over the 1M rows)
STREAM_CHUNK, STREAM_LOGREG_CHUNK = 8192, 65536
# the JAX bench arm's own shape (bench.py:609-611): 400,000 x 512 linear rows
STREAM_BENCH_ROWS, STREAM_BENCH_COLS, STREAM_BENCH_SEED = 400_000, 512, 3
STREAM_PROFILE_CHUNKS = 10
# the KMeans engine's running centers are scored on 65,536 held-out rows of
# the same blobs after its first chunk and at a third, two thirds and all
# of the stream
STREAM_EVAL_ROWS, STREAM_EVAL_POINTS, STREAM_EVAL_SEED = 65536, (0.0, 1 / 3, 2 / 3, 1.0), 5
# the live index on the ANN cell: 10 adds of 10,000 rows from the same
# blobs, 50,000 deletes, one add that overflows L_pad (a repack)
LIVE_ADDS, LIVE_ADD_ROWS, LIVE_DELETES, LIVE_SEED = 10, 10_000, 50_000, 43
LIVE_MESH_QUERIES = 2048  # path_live_mesh: the searches before and after the script
LIVE_SERVE_ADDS = 64  # path_serve: rows added through the streaming session after its refresh
# stream_card_vs_cpu: 65,536 x 256 integer rows, each engine on the card
# and under use_device("cpu"); the live index at nlist 256, nprobe 16
SCVC_ROWS, SCVC_COLS, SCVC_CHUNK, SCVC_SEED, SCVC_K = 65536, 256, 8192, 91, 16
SCVC_NLIST, SCVC_NPROBE, SCVC_QUERIES, SCVC_HOT_FRACTION = 256, 16, 256, 0.5
# the kmeans running cost (a difference-form sum of non-integer residuals)
# card against CPU; the logistic iterate averages (L-BFGS iterates in float32
# on two devices) within glm_card_vs_cpu's logistic tolerance
SCVC_COST_RTOL = 1e-6
STREAM_PHASES = ("path_stream", "stream_card_vs_cpu")


def stream_chunks(n, chunk):
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def timed_stream(torch, port, engine, X, y, chunk, n=None):
    """Every chunk of the first n rows through engine.partial_fit (contiguous
    slices, as bench.py's arm), then finalize: (model, record).  The ingest
    rate is timed from the second chunk on (bench_streaming.py's window: the
    first chunk allocates the staging buffers, and KMeans's first chunk
    runs its init)."""
    n = X.shape[0] if n is None else n
    chunks = stream_chunks(n, chunk)
    port.profiling.reset_phase_times()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.partial_fit(X[chunks[0]], y=None if y is None else y[chunks[0]])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sl in chunks[1:]:
        engine.partial_fit(X[sl], y=None if y is None else y[sl])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = engine.finalize()
    finalize_s = time.perf_counter() - t0
    timed_rows = n - (chunks[0].stop - chunks[0].start)
    return model, {
        "rows": n, "chunk_rows": chunk, "chunks": len(chunks), "first_chunk_s": first_s, "ingest_s": ingest_s,
        "streaming_ingest_rows_per_s": timed_rows / ingest_s, "ms_per_chunk": 1e3 * ingest_s / (len(chunks) - 1),
        "finalize_s": finalize_s, "phase_s": port.profiling.phase_times(),
    }


def stream_profile(torch, engine, X, y, chunk, start):
    """STREAM_PROFILE_CHUNKS more chunks under the profiler: stream.update's
    host milliseconds, the card's busy time split into copies (memcpy /
    memset) and kernels, and the idle share."""
    sls = stream_chunks(X.shape[0], chunk)[start : start + STREAM_PROFILE_CHUNKS]
    rec = profile_once(torch, lambda: [engine.partial_fit(X[sl], y=None if y is None else y[sl]) for sl in sls],
                       ("stream.update",))
    rec["chunks"] = len(sls)
    return rec


def stream_linreg_part(torch, port, wrappers, X, y):
    """The linear engine on path_linreg's rows (OLS) against the port's batch
    fit of the same rows, held-out R^2; the bench arm's shape; a profile of
    10 chunks."""
    t0 = time.perf_counter()
    est = port.LinearRegression(**LINREG_FITS["ols"])
    reset_launches(wrappers)
    model, rec = timed_stream(torch, port, est.streaming(), X, y, STREAM_CHUNK, GLM_ROWS)
    rec["launches"] = read_launches(wrappers)
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], y[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    batch, rec["batch_fit_s"], _, _ = timed_fit(torch, est, df, wrappers)
    del df
    scale = float(np.abs(batch.coef_).max())
    rec["coef_max_rel_err_vs_batch"] = float(np.abs(model.coef_ - batch.coef_).max()) / scale
    rec["intercept_rel_err_vs_batch"] = abs(model.intercept_ - batch.intercept_) / scale
    check(rec["coef_max_rel_err_vs_batch"] <= LINREG_RTOL and rec["intercept_rel_err_vs_batch"] <= LINREG_RTOL,
          f"streamed linear model against the batch fit: {rec}")
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    y_hold = y[GLM_ROWS:].astype(np.float64)
    pred = concat_col(model.transform(hold), "prediction")
    rec["holdout_r2"] = float(1.0 - ((pred - y_hold) ** 2).mean() / y_hold.var())
    check(rec["holdout_r2"] > HOLDOUT_R2, f"streamed linear model: held-out R^2 {rec['holdout_r2']}")
    engine = est.streaming()
    engine.partial_fit(X[:STREAM_CHUNK], y=y[:STREAM_CHUNK])
    rec["profile"] = stream_profile(torch, engine, X, y, STREAM_CHUNK, 1)
    rng = np.random.default_rng(STREAM_BENCH_SEED)
    Xb = normal_data(STREAM_BENCH_ROWS, STREAM_BENCH_COLS, STREAM_BENCH_SEED)
    yb = (Xb @ rng.standard_normal(STREAM_BENCH_COLS, dtype=np.float32)
          + np.float32(0.1) * rng.standard_normal(STREAM_BENCH_ROWS, dtype=np.float32))
    bench_model, bench = timed_stream(torch, port, port.LinearRegression(standardization=False).streaming(), Xb,
                                      yb, STREAM_CHUNK)
    check(np.isfinite(bench_model.coef_).all(), "the bench arm's coefficients are not finite")
    rec["bench_arm"] = {"cols": STREAM_BENCH_COLS, **bench}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def stream_pca_part(torch, port, wrappers, X):
    """The PCA engine on path_pca's low-rank rows X against the port's batch
    fit of the same rows (the PCA gates)."""
    t0 = time.perf_counter()
    est = port.PCA(k=PCA_K)
    reset_launches(wrappers)
    model, rec = timed_stream(torch, port, est.streaming(), X, None, STREAM_CHUNK)
    rec["launches"] = read_launches(wrappers)
    batch, rec["batch_fit_s"], _, _ = timed_fit(torch, est, port.DataFrame.from_numpy(
        X, num_partitions=GLM_PARTITIONS), wrappers)
    rec["errors_vs_batch"] = errs = {
        "mean_max_abs_err": float(np.abs(model.mean_ - batch.mean_).max()),
        "components_max_abs_err": float(np.abs(model.components_ - batch.components_).max()),
        "ratio_max_abs_err": float(np.abs(model.explained_variance_ratio_ - batch.explained_variance_ratio_).max()),
        "singular_values_max_rel_err": float(np.abs(model.singular_values_ / batch.singular_values_ - 1.0).max()),
    }
    check(np.array_equal(np.sign(model.components_[np.arange(PCA_K), np.abs(batch.components_).argmax(axis=1)]),
                         np.sign(batch.components_[np.arange(PCA_K), np.abs(batch.components_).argmax(axis=1)])),
          "component signs differ")
    check(errs["mean_max_abs_err"] <= PCA_MEAN_ATOL and errs["components_max_abs_err"] <= PCA_COMP_ATOL
          and errs["ratio_max_abs_err"] <= PCA_RATIO_ATOL and errs["singular_values_max_rel_err"] <= PCA_SV_RTOL,
          f"streamed PCA against the batch fit: {errs}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def stream_kmeans_part(torch, port, wrappers, dev, X):
    """The KMeans engine (the KMeans cell's k, maxIter, init and seed) on the
    KMeans cell's rows X: its running cost finite, the running centers'
    inertia on STREAM_EVAL_ROWS held-out rows of the same blobs (plain torch
    on the card, float64 sums) falling at each of STREAM_EVAL_POINTS, and
    the finalized centers saved and loaded bit for bit."""
    t0 = time.perf_counter()
    centers = np.random.default_rng(SEED).uniform(-10.0, 10.0, size=(K, COLS)).astype(np.float32)  # blobs()'s
    rng = np.random.default_rng(STREAM_EVAL_SEED)
    held = centers[rng.integers(0, K, STREAM_EVAL_ROWS)] + rng.standard_normal((STREAM_EVAL_ROWS, COLS), np.float32)
    gen_s = time.perf_counter() - t0
    engine = port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED).streaming()
    n_chunks = len(stream_chunks(ROWS, STREAM_CHUNK))
    at = {max(1, round(f * n_chunks)) for f in STREAM_EVAL_POINTS}
    Xs = torch.from_numpy(held).to(dev)
    xs_norm = (Xs * Xs).sum(dim=1)
    inertia = []

    class Tracked:
        """partial_fit that, at the chunk counts in `at`, scores the running
        centers on the held-out rows (plain torch, no kernel of the
        port's)."""

        def partial_fit(self, chunk, y=None):
            engine.partial_fit(chunk)
            if engine.chunks_ingested in at:
                C = engine._running_centers(dev).to(torch.float32)
                best = plain_top2(torch, Xs, C, xs_norm, (C * C).sum(dim=1))[0]
                inertia.append([engine.chunks_ingested, float(best.clamp_min(0).double().sum())])

        def finalize(self):
            return engine.finalize()

    reset_launches(wrappers)
    model, rec = timed_stream(torch, port, Tracked(), X, None, STREAM_CHUNK)
    rec["launches"] = read_launches(wrappers)
    del Xs
    rec["sample_inertia"] = inertia
    rec["inertia"] = model.inertia_
    values = [v for _, v in inertia]
    check(math.isfinite(model.inertia_) and np.isfinite(values).all(), "non-finite running inertia")
    check(all(a > b for a, b in zip(values, values[1:])), f"the sample inertia does not fall over the stream: {inertia}")
    model_dir = os.path.join(REPO, "build", "chip_smoke_stream_kmeans")
    shutil.rmtree(model_dir, ignore_errors=True)
    model.save(model_dir)
    check(np.array_equal(port.load(model_dir).cluster_centers_, model.cluster_centers_),
          "the reloaded streamed centers differ")
    rec["reloaded_identical"] = True
    rec["held_out_gen_s"] = gen_s
    rec["seconds"] = time.perf_counter() - t0
    return rec


def stream_logreg_part(torch, port, wrappers, X, y):
    """The logistic engine (path_logreg's params) on path_logreg's rows in
    65,536-row chunks: held-out accuracy."""
    t0 = time.perf_counter()
    yb = (y > 0).astype(np.float32)
    reset_launches(wrappers)
    model, rec = timed_stream(torch, port, port.LogisticRegression(**LOGREG).streaming(), X, yb,
                              STREAM_LOGREG_CHUNK, GLM_ROWS)
    rec["launches"] = read_launches(wrappers)
    hold = port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)
    rec["holdout_accuracy"] = float((concat_col(model.transform(hold), "prediction") == yb[GLM_ROWS:]).mean())
    check(rec["holdout_accuracy"] > HOLDOUT_ACCURACY, f"streamed logistic model: accuracy {rec['holdout_accuracy']}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def live_index_part(torch, port, ivf, pq_mod, knn_ops, kk, nc, wrappers, dev, X, Q, serve=None, mesh_ref=None):
    """The live index on the ANN cell (items X, queries Q): fit,
    mutable_index(), kneighbors of the 16,384 queries, 10 adds of 10,000
    rows (B1 once each), 50,000 deletes (checked on 2,048 queries: no
    deleted id, B7 against lex_topk on the tombstoned pool), one add
    overflowing L_pad (a repack), kneighbors of the 16,384 queries again;
    then recall@10 against exactSearch over the frozen live set, and freeze
    -> save -> load identical.  With `mesh_ref` (path_live_mesh), the
    script's inputs, the holder's searches of LIVE_MESH_QUERIES queries
    before and after it and its to_packed() after it are put there, outside
    the counted window."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(LIVE_SEED)
    centers = 10.0 * np.random.default_rng(ANN_SEED).standard_normal((max(32, ANN_NLIST), ANN_COLS), dtype=np.float32)
    lab = rng.integers(0, centers.shape[0], size=LIVE_ADDS * LIVE_ADD_ROWS)
    adds = centers[lab] + rng.standard_normal((len(lab), ANN_COLS), dtype=np.float32)
    gen_s = time.perf_counter() - t0
    query_df = port.DataFrame.from_numpy(Q, num_partitions=ANN_QUERY_PARTS)
    check_df = port.DataFrame.from_numpy(Q[:ANN_CHECK_QUERIES])
    t0 = time.perf_counter()
    model = port.ApproximateNearestNeighbors(k=ANN_K, algorithm="ivfflat", algoParams=dict(_ANN_BASE)).fit(
        port.DataFrame.from_numpy(X, num_partitions=ANN_ITEM_PARTS))
    fit_s = time.perf_counter() - t0
    if mesh_ref is not None:
        mesh_ref["packed"] = model._packed()
    holder, stage_s = synced(torch, model.mutable_index)
    rec = {"items": ANN_ITEMS, "queries": ANN_QUERIES, "k": ANN_K, "fit_s": fit_s, "stage_s": stage_s,
           "data_gen_s": gen_s, "l_pad_before": holder.stats()["l_pad"]}
    if mesh_ref is not None:
        mesh_ref["before"] = holder.search(Q[:LIVE_MESH_QUERIES], ANN_K, ANN_NPROBE)
    torch.cuda.synchronize()
    reset_launches(wrappers)
    port.profiling.reset_counters("ann.mutate.")
    (idx0, _), before_s = synced(torch, lambda: ann_rows(model, query_df))
    rec["kneighbors_rows_per_s_before"] = ANN_QUERIES / before_s
    add_s = []
    for j in range(LIVE_ADDS):
        rows = slice(j * LIVE_ADD_ROWS, (j + 1) * LIVE_ADD_ROWS)
        _, s = synced(torch, lambda: holder.add_items(adds[rows], ANN_ITEMS + np.arange(rows.start, rows.stop)))
        add_s.append(s)
    rec["add_s"] = add_s
    rec["add_rows_per_s"] = LIVE_ADDS * LIVE_ADD_ROWS / sum(add_s)
    live_ids = np.concatenate([np.arange(ANN_ITEMS), ANN_ITEMS + np.arange(len(adds))])
    deleted = rng.choice(live_ids, size=LIVE_DELETES, replace=False)
    n_del, rec["delete_s"] = synced(torch, lambda: holder.delete_items(deleted))
    check(n_del == LIVE_DELETES, f"{n_del} of {LIVE_DELETES} deletes")
    i_t, _ = ann_rows(model, check_df)
    check(not np.isin(i_t, deleted).any(), "a deleted id came back from the tombstoned index")
    tombstoned = holder.index  # a snapshot: B7 is checked on its pool after the counted window
    # one add into the fullest list, one row past its slots (tombstones
    # included): the add repacks
    full = int(np.argmax(holder._counts))
    burst_n = holder.stats()["l_pad"] - int(holder._counts[full]) + 1
    burst = (model.centroids_[full] + 0.01 * rng.standard_normal((burst_n, ANN_COLS))).astype(np.float32)
    burst_ids = ANN_ITEMS + len(adds) + np.arange(burst_n)
    _, rec["repack_add_s"] = synced(torch, lambda: holder.add_items(burst, burst_ids))
    rec["stats_after"] = stats = holder.stats()
    check(stats["repacks"] == 1 and stats["tombstoned"] == 0, f"the overflowing add did not repack: {stats}")
    rec["burst_rows"] = burst_n
    (idx1, dist1), after_s = synced(torch, lambda: ann_rows(model, query_df))
    rec["kneighbors_rows_per_s_after"] = ANN_QUERIES / after_s
    rec["launches"] = launches = read_launches(wrappers)
    rec["counters"] = port.profiling.counters("ann.mutate.")
    if mesh_ref is not None:
        mesh_ref.update(adds=adds, deleted=deleted, burst=burst, burst_ids=burst_ids, one_shard=dict(rec),
                        after=holder.search(Q[:LIVE_MESH_QUERIES], ANN_K, ANN_NPROBE), packed_after=holder.to_packed())
    check(launches["min_dist_argmin"] == LIVE_ADDS + 1, f"the adds launched min_dist_argmin {launches}")
    check(launches["knn_fused_merge"] > 0, "the live searches launched knn_fused_merge no time")
    check(not np.isin(idx1, deleted).any(), "a deleted id came back after the repack")
    check(bool(np.isfinite(dist1).all()) and bool((idx1 >= 0).all()), "an unfilled slot after the mutations")
    rec["merge_vs_lex_topk_tombstoned"] = ann_merge_check(torch, ivf, pq_mod, knn_ops, kk, tombstoned, Q, ANN_K,
                                                          False, dev)
    del tombstoned
    # B1 at the add's shape against its plain version
    cent = torch.from_numpy(np.ascontiguousarray(model.centroids_)).to(dev)
    xa = torch.from_numpy(adds[:LIVE_ADD_ROWS]).to(dev)
    m, a = nc.min_dist_argmin(xa, cent)
    best, parg, second = plain_top2(torch, xa, cent, nc.squared_norms(xa), (cent * cent).sum(dim=1))
    off = (a.long() != parg) & ~near_ties(best, second)
    check(int(off.sum()) == 0, f"B1 at the add's shape: {int(off.sum())} rows off near-ties")
    rec["b1_add_shape"] = {"n": LIVE_ADD_ROWS, "d": ANN_COLS, "k": int(cent.shape[0]),
                           "max_abs_err": float((m - best).abs().max())}
    if serve is not None:
        # path_serve: the live model refreshed into the router, one add
        # through the session, the added rows deleted again before freezing
        noise = np.random.default_rng(LIVE_SEED + 1).standard_normal((LIVE_SERVE_ADDS, ANN_COLS))
        fresh = (adds[:LIVE_SERVE_ADDS] + 0.01 * noise).astype(np.float32)
        fresh_ids = burst_ids[-1] + 1 + np.arange(LIVE_SERVE_ADDS)
        serve.live_refresh(model, holder, fresh, fresh_ids)
        check(holder.delete_items(fresh_ids) == LIVE_SERVE_ADDS, "the served adds were not deleted again")
    model.freeze_mutations()
    model.setExactSearch(True)
    i_ex, _ = ann_rows(model, check_df)
    model.setExactSearch(False)
    rec["recall_at_10"] = ivf.recall_at_k(idx1[:ANN_CHECK_QUERIES, :10], i_ex[:, :10])
    check(rec["recall_at_10"] >= ANN_ARMS["path_ann"][2], f"live recall@10 {rec['recall_at_10']}")
    check(not np.isin(i_ex, deleted).any(), "the frozen payload holds a deleted id")
    i_f, d_f = ann_rows(model, check_df)
    model_dir = os.path.join(REPO, "build", "chip_smoke_live_ann")
    shutil.rmtree(model_dir, ignore_errors=True)
    model.save(model_dir)
    i_l, d_l = ann_rows(port.load(model_dir), check_df)
    check(np.array_equal(i_l, i_f) and np.array_equal(d_l.view(np.uint32), d_f.view(np.uint32)),
          "freeze -> save -> load gives other results")
    rec["frozen_items"] = model.n_items
    rec["reloaded_identical"] = True
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run_stream_path(parts):
    """Phase path_stream's record: its parts (the engines and the live
    index), each run beside the path that made its rows (main), with the
    launch counters reset before it and read after it."""
    launches = {name: sum(p["launches"].get(name, 0) for p in parts.values())
                for name in ("min_dist_argmin", "knn_fused_merge")}
    return {"phase": "path_stream", "rows_cut": False, "seconds": sum(p["seconds"] for p in parts.values()),
            "gates": {"linreg_rtol_vs_batch": LINREG_RTOL, "holdout_r2_above": HOLDOUT_R2,
                      "pca_gates": [PCA_MEAN_ATOL, PCA_COMP_ATOL, PCA_RATIO_ATOL, PCA_SV_RTOL],
                      "holdout_accuracy_above": HOLDOUT_ACCURACY, "live_recall_at_10": ANN_ARMS["path_ann"][2]},
            "launches": launches, **parts}


def integer_blob_rows(rows, cols, k, seed):
    """Integer rows around k well separated integer centers (|x| <= 33) and
    an integer label (|y| <= 40): every sum over SCVC_CHUNK rows of x x', x y
    and y^2 stays under 2^24, so each chunk partial is exact in float32."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-6, 7, size=(k, cols)) * 5
    X = (centers[rng.integers(0, k, rows)] + rng.integers(-3, 4, size=(rows, cols))).astype(np.float32)
    return X, np.clip(X[:, 0] + X[:, 1] - X[:, 2], -40, 40)


def stream_card_vs_cpu(torch, port, wrappers, card="cuda"):
    """Phase stream_card_vs_cpu: each engine's state on the card and under
    use_device("cpu") after the same chunks of integer rows: linear and PCA
    bit for bit; KMeans, the CPU engine adopting the card's state after the
    first chunk (its init), sums, counts and anchor bit for bit and the cost
    within SCVC_COST_RTOL; logistic, on Gaussian rows, within
    CVC_LOGISTIC_ATOL.  Then the live
    index, one payload fitted on the card, after the same mutations on the
    card, on the CPU and tiered on the card (an add, deletes, an add that
    regrows L_pad, more deletes): to_packed() equal, search ids and
    distances bit for bit.
    `card` is the device held against the CPU ("cpu" rehearses the phase on
    a host without a card)."""
    from spark_rapids_ml_tpu_torch.ann.mutable import MutableIVFIndex

    X, y = integer_blob_rows(SCVC_ROWS, SCVC_COLS, SCVC_K, SCVC_SEED)
    # the logistic engine on Gaussian rows and noisy labels (glm_card_vs_cpu's
    # setting): each chunk's L-BFGS converges to its optimum on both devices
    rng = np.random.default_rng(SCVC_SEED + 1)
    Xg = normal_data(SCVC_ROWS, SCVC_COLS, SCVC_SEED)
    yg = (Xg @ rng.standard_normal(SCVC_COLS, dtype=np.float32)
          + rng.standard_normal(SCVC_ROWS, dtype=np.float32) > 0).astype(np.float32)
    chunks = stream_chunks(SCVC_ROWS, SCVC_CHUNK)
    engines = {
        "linreg": (lambda: port.LinearRegression().streaming(), X, y),
        "pca": (lambda: port.PCA(k=PCA_K).streaming(), X, None),
        "kmeans": (lambda: port.KMeans(k=SCVC_K, maxIter=10, seed=SEED).streaming(), X, None),
        "logreg": (lambda: port.LogisticRegression(regParam=1e-3, maxIter=200, tol=1e-6).streaming(), Xg, yg),
    }
    out = {}
    for name, (make, rows, labels) in engines.items():
        states, first = {}, None
        for where in (card, "cpu"):
            with port.device.use_device(where):
                eng = make()
                t0 = time.perf_counter()
                for j, sl in enumerate(chunks):
                    if name == "kmeans" and j == 0 and first is not None:
                        eng.merge(first)  # the card's init anchor and first chunk
                        continue
                    eng.partial_fit(rows[sl], y=None if labels is None else labels[sl])
                    if name == "kmeans" and j == 0:
                        first = eng.state.copy()
                states[where] = (eng.state, time.perf_counter() - t0)
        (card_state, card_s), (cpu_state, cpu_s) = states[card], states["cpu"]
        on_card, on_cpu = card_state.arrays, cpu_state.arrays
        rec = {"card_s": card_s, "cpu_s": cpu_s}
        if name in ("linreg", "pca"):
            check(card_state == cpu_state, f"{name}: the card's state differs from the CPU's")
            rec["bit_for_bit"] = True
        elif name == "kmeans":
            for f in ("sums", "counts", "init_centers"):
                check(np.array_equal(on_card[f], on_cpu[f]), f"kmeans {f} differ card against CPU")
            rec["cost_rel_err"] = float(abs(on_card["cost"] / on_cpu["cost"] - 1.0))
            check(rec["cost_rel_err"] <= SCVC_COST_RTOL, f"kmeans cost: {rec}")
        else:
            check(np.array_equal(on_card["classes"], on_cpu["classes"]) and on_card["wsum"] == on_cpu["wsum"],
                  "logistic anchors")
            scale = max(1.0, float(np.abs(on_cpu["WS"] / on_cpu["wsum"]).max()))
            rec["coef_max_abs_err"] = float(np.abs(on_card["WS"] - on_cpu["WS"]).max() / on_cpu["wsum"]) / scale
            check(rec["coef_max_abs_err"] <= CVC_LOGISTIC_ATOL, f"logistic state: {rec}")
        out[name] = rec
    # the live index
    t0 = time.perf_counter()
    with port.device.use_device(card):
        model = port.ApproximateNearestNeighbors(
            k=10, algoParams={"nlist": SCVC_NLIST, "nprobe": SCVC_NPROBE}).fit(port.DataFrame.from_numpy(X))
    # integer centroids (the fit's, rounded): an add's distances are exact
    # integers, so B1 and its plain version assign every row alike
    fit = model._packed()
    packed = type(fit)(fit.items, fit.ids, fit.counts, np.round(fit.centroids), fit.n_lists, fit.n_items)
    extra = integer_blob_rows(4096, SCVC_COLS, SCVC_K, SCVC_SEED)[0] + rng.integers(-1, 2, size=(4096, SCVC_COLS))
    l_pad0 = ivf_geometry_l_pad(packed)
    # identical rows: one list takes them all, past any slot count
    burst = np.repeat(packed.centroids[:1], l_pad0 + 1, axis=0).astype(np.float32)
    Q = X[rng.choice(SCVC_ROWS, SCVC_QUERIES, replace=False)]
    results = {}
    for where, hot in ((card, 1.0), ("cpu", 1.0), (card, SCVC_HOT_FRACTION)):
        holder = MutableIVFIndex(packed, torch.device(where), hot_fraction=hot)
        reset_launches(wrappers)
        holder.add_items(extra.astype(np.float32), 10**6 + np.arange(len(extra)))
        holder.delete_items(np.arange(0, SCVC_ROWS, 7))
        holder.add_items(burst, 2 * 10**6 + np.arange(len(burst)))
        holder.delete_items(2 * 10**6 + np.arange(0, len(burst), 3))
        results[where, hot] = (holder.to_packed(), holder.search(Q, 10, SCVC_NPROBE), holder.stats(),
                               read_launches(wrappers), getattr(holder.index, "tier", None))
    (pc, (dc, ic), sc, lc, _), (pp, (dp, ip), _, _, _) = results[card, 1.0], results["cpu", 1.0]
    pt, (dt, it), _, _, tier = results[card, SCVC_HOT_FRACTION]
    for f in ("items", "ids", "counts", "centroids"):
        check(np.array_equal(getattr(pc, f), getattr(pp, f)) and np.array_equal(getattr(pc, f), getattr(pt, f)),
              f"live index to_packed {f}: card, CPU and the card's tiered index differ")
    check(np.array_equal(ic, ip) and np.array_equal(dc.view(np.uint32), dp.view(np.uint32)),
          "live index search: card against CPU")
    check(np.array_equal(ic, it) and np.array_equal(dc.view(np.uint32), dt.view(np.uint32)),
          "live index search: the card's tiered index against its resident one")
    tier_stats = tier.stats()
    check(tier_stats["misses"] > 0, f"the tiered live index paged nothing: {tier_stats}")
    check(sc["l_pad"] > l_pad0 and sc["repacks"] == 1, f"the burst did not regrow L_pad: {sc}")
    check(lc["min_dist_argmin"] == 2 and lc["knn_fused_merge"] > 0, f"the card's live index launched {lc}")
    out["live_index"] = {"seconds": time.perf_counter() - t0, "items": int(pc.n_items), "l_pad": [l_pad0, sc["l_pad"]],
                         "stats": sc, "ids_and_distances_equal": True, "launches": lc,
                         "tiered": {"hot_fraction": SCVC_HOT_FRACTION, "equal_to_resident": True, **tier_stats}}
    return {"phase": "stream_card_vs_cpu", "rows": SCVC_ROWS, "cols": SCVC_COLS, "chunk_rows": SCVC_CHUNK,
            "gates": {"kmeans_cost_rtol": SCVC_COST_RTOL, "logistic_atol": CVC_LOGISTIC_ATOL}, **out}


def ivf_geometry_l_pad(packed):
    from spark_rapids_ml_tpu_torch.ann.ivfflat import padded_layout_geometry

    return padded_layout_geometry(packed.n_lists, packed.counts)[2]


# ---------------------------------------------------------------------------
# Serving: path_serve, the models of the path phases behind the online layer
# ---------------------------------------------------------------------------

# One ModelServer a model at the JAX package's serving defaults (max_batch
# 256, max_wait_ms 5, min_bucket 16); 4 client threads, each keeping up to
# SERVE_WINDOW requests outstanding, send requests of 1-64 rows (uniform)
# drawn from the path's own rows.
SERVE_OPTS = dict(max_batch=256, max_wait_ms=5.0)
SERVE_CLIENTS, SERVE_WINDOW, SERVE_SEED = 4, 8, 16
SERVE_REQUESTS = {"kmeans": 2000, "rf_clf": 2000, "linreg": 2000, "logreg": 2000, "pca": 2000,
                  "knn": 500, "ivfflat": 500, "ivfpq": 200}
SERVE_CHECK_ROWS = 1024      # served against the batch call on these rows
SERVE_RTOL = SERVE_ATOL = 1e-5  # GLM and PCA outputs (tests/test_serving.py:447-462)
SERVE_PROFILE_REQUESTS = 200
SERVE_ROUTER_REPLICAS = 2
SERVE_BUDGET_S = 60.0  # the phase's share of the script's time limit (recorded, not a gate)
# the kernels whose served launches the phase counts
SERVE_KERNELS = ("min_dist_argmin", "knn_candidates", "knn_fused_merge", "lut_accumulate_probed")
SERVE_ANN_ARMS = {"path_ann": "ivfflat", "path_ann_pq": "ivfpq"}  # the 4-bit arm is not served (time)


def serve_traffic(srv, X, n_requests, seed, submit=None, model_ids=None):
    """SERVE_CLIENTS client threads send n_requests requests of 1-64 rows of
    X through `submit` (default srv.submit), each with up to SERVE_WINDOW
    outstanding: (rows sent, seconds until every answer is in).  With
    `model_ids` (one a request) request i goes to tenant model_ids[i]."""
    submit = submit or srv.submit
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 65, n_requests)
    starts = rng.integers(0, len(X) - 64, n_requests)

    def client(c):
        window = []
        for i in range(c, n_requests, SERVE_CLIENTS):
            kw = {} if model_ids is None else {"model_id": model_ids[i]}
            window.append(submit(X[starts[i] : starts[i] + sizes[i]], **kw))
            if len(window) >= SERVE_WINDOW:
                window.pop(0).result(timeout=600)
        for fut in window:
            fut.result(timeout=600)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        for fut in [pool.submit(client, c) for c in range(SERVE_CLIENTS)]:
            fut.result()
    return int(sizes.sum()), time.perf_counter() - t0


def served_rows(srv, X, **kw):
    """The outputs of serving X in requests of 64 rows, concatenated (`kw`
    goes to each submit: a multiplexed server's model_id)."""
    futs = [srv.submit(X[i : i + 64], **kw) for i in range(0, len(X), 64)]
    outs = [f.result(timeout=600) for f in futs]
    return {c: np.concatenate([o[c] for o in outs]) for c in outs[0]}


def same_up_to_ties(d_a, i_a, d_b, i_b, rtol):
    """Rows whose neighbour ids differ other than by ties: the distances
    must agree within rtol, and the ids strictly inside a row's k-th
    distance (by more than rtol) must be the same sets."""
    check(np.allclose(d_a, d_b, rtol=rtol, atol=0.0), "served distances differ from the batch call's")
    bad = 0
    for r in np.flatnonzero((i_a != i_b).any(axis=1)):
        edge = d_b[r, -1] * (1.0 - rtol)
        bad += set(i_a[r][d_a[r] < edge].tolist()) != set(i_b[r][d_b[r] < edge].tolist())
    return int((i_a != i_b).any(axis=1).sum()), bad


def serve_timed(method):
    """A ServePlane part whose whole time (its gates, traffic, kernel
    timings and extra checks) counts to the phase's seconds."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(self, *args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0

    return run


class ServePlane:
    """Phase path_serve: each path's model behind one ModelServer, served
    right after its path while the path's rows exist; the KMeans model also
    behind a 2-replica Router (a rolling swap to other centers under
    traffic, and the live index of path_stream refreshed into it) and
    through one injected worker death."""

    def __init__(self, torch, port, nc, kk, knn_ops, wrappers, dev):
        self.torch, self.port, self.nc, self.wrappers, self.dev = torch, port, nc, wrappers, dev
        self.kk, self.knn_ops = kk, knn_ops
        self.parts = {}
        self.router = None
        self.seconds = 0.0

    # -- one model ---------------------------------------------------------------
    def serve(self, key, model, X, check_rows):
        """Serve `model` (check_rows(served, rows) holds the served outputs on
        SERVE_CHECK_ROWS rows against the batch call), then its traffic with
        every launch counter reset just before and read just after."""
        torch, port = self.torch, self.port
        S = port.serving
        name = f"serve_{key}"
        t_part = time.perf_counter()
        t0 = time.perf_counter()
        srv = S.ModelServer(name, model, **SERVE_OPTS)
        warm_s = time.perf_counter() - t0
        try:
            rec = {"requests": SERVE_REQUESTS[key], "buckets": srv.buckets, "warm_s": warm_s,
                   "warm_dispatch_ms": [1e3 * s for s in port.profiling.durations(
                       f"serve.{name}.warm_dispatch")[f"serve.{name}.warm_dispatch"]]}
            rec["check"] = check_rows(served_rows(srv, X[:SERVE_CHECK_ROWS]), X[:SERVE_CHECK_ROWS])
            port.profiling.reset_durations(f"serve.{name}.")
            before = port.profiling.counters(f"serving.{name}.")
            torch.cuda.synchronize()
            reset_launches(self.wrappers)
            rows, seconds = serve_traffic(srv, X, SERVE_REQUESTS[key], SERVE_SEED)
            launches = read_launches(self.wrappers)
            moved = port.profiling.counter_deltas(before, f"serving.{name}.")
            stats = srv.stats()
            srv.drain()
            srv.assert_steady_state()
        finally:
            srv.shutdown(drain=False)
        batches = moved.get(f"serving.{name}.batches", 0)
        lat = stats["latency"]
        rec.update({
            "rows": rows, "seconds": seconds, "rows_per_s": rows / seconds,
            "latency_ms": {q: 1e3 * lat[q] for q in ("p50", "p95", "p99", "max")},
            "batches": batches, "mean_batch_rows": rows / max(batches, 1),
            "mean_requests_per_batch": stats["batch_occupancy"].get("mean"),
            "dispatch_ms_by_bucket": {b: {"p50": 1e3 * d["p50"], "count": d["count"]}
                                      for b, d in stats["dispatch_by_bucket"].items() if d},
            "launches": {k: launches[k] for k in SERVE_KERNELS},
            "steady_compiles": stats["steady_compiles"], "counters": moved,
        })
        check(moved.get(f"serving.{name}.requests", 0) == SERVE_REQUESTS[key], f"{name}: requests {moved}")
        check(not moved.get(f"serving.{name}.errors"), f"{name}: dispatch errors {moved}")
        rec["part_s"] = time.perf_counter() - t_part
        self.parts[key] = rec
        return rec

    # -- per-model gates -----------------------------------------------------------
    @serve_timed
    def kmeans(self, model, X):
        torch, nc = self.torch, self.nc
        C = torch.from_numpy(np.ascontiguousarray(model.cluster_centers_, np.float32)).to(self.dev)

        def check_rows(served, rows):
            want = model.transform(self.port.DataFrame.from_numpy(rows)).partitions[0]["prediction"]
            Xc = torch.from_numpy(rows).to(self.dev)
            best, parg, second = plain_top2(torch, Xc, C, nc.squared_norms(Xc), (C * C).sum(dim=1))
            ties = near_ties(best, second).cpu().numpy()
            off = (served["prediction"] != want) & ~ties
            check(not off.any(), f"served KMeans labels differ from transform at {int(off.sum())} rows off near-ties")
            return {"rows": len(rows), "differ": int((served["prediction"] != want).sum()), "near_ties": int(ties.sum())}

        rec = self.serve("kmeans", model, X, check_rows)
        check(rec["launches"]["min_dist_argmin"] > 0, "served KMeans batches launched min_dist_argmin no time")
        # B1 at each serving bucket (CUDA events; not counted launches)
        rec["min_dist_argmin_ms_by_bucket"] = {
            b: median_ms(torch, lambda Xb=torch.from_numpy(X[:b]).to(self.dev): nc.min_dist_argmin(Xb, C), 20)
            for b in rec["buckets"]}
        rec["profile"] = self.kmeans_profile(model, X)
        rec["worker_death"] = self.worker_death(model, X)
        self.router_part(model, X)
        return rec

    def kmeans_profile(self, model, X):
        """device_idle_share of SERVE_PROFILE_REQUESTS served KMeans requests
        under torch.profiler (one more server, warmed before the trace)."""
        srv = self.port.serving.ModelServer("serve_kmeans_prof", model, **SERVE_OPTS)
        try:
            prof = profile_once(self.torch, lambda: serve_traffic(srv, X, SERVE_PROFILE_REQUESTS, SERVE_SEED + 1),
                                ("serve.serve_kmeans_prof.dispatch",))
        finally:
            srv.shutdown(drain=False)
        return {k: prof[k] for k in ("profiled_ms", "device_busy_ms", "device_copy_ms", "device_idle_share",
                                     "top_device_ms", "port_kernel_ms", "port_launches")}

    def worker_death(self, model, X):
        """One injected worker death (the port's serving.dispatch fault site):
        the request it took fails with the retryable ServerRecovering, the
        supervisor re-warms a new worker, and the next requests succeed; the
        recovered worker's first (warm) dispatch and first request timed."""
        port = self.port
        S, faults = port.serving, port.parallel.faults
        name = "serve_kmeans_death"
        srv = S.ModelServer(name, model, **SERVE_OPTS)
        try:
            srv.predict(X[:8])
            os.environ[faults.FAULTS_ENV] = f"serving.dispatch:tag={name}:call=1:action=kill"
            faults.reload()
            try:
                try:
                    srv.predict(X[:8])
                    failed = None
                except S.ServerRecovering as exc:
                    failed = type(exc).__name__ if exc.retryable else "not retryable"
            finally:
                del os.environ[faults.FAULTS_ENV]
                faults.reload()
            check(failed == "ServerRecovering", f"the killed worker's request gave {failed}")
            deadline = time.perf_counter() + 60
            while (srv.state() != S.READY or port.profiling.counter(f"serving.{name}.restarts") < 1) \
                    and time.perf_counter() < deadline:
                time.sleep(0.005)
            check(srv.state() == S.READY, f"the server did not recover: {srv.state()}")
            warm = port.profiling.durations(f"serve.{name}.warm_dispatch")[f"serve.{name}.warm_dispatch"]
            n = len(srv.buckets)
            t0 = time.perf_counter()
            out = srv.predict(X[:8])
            first_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            srv.predict(X[:8])
            second_ms = 1e3 * (time.perf_counter() - t0)
            want = model.transform(port.DataFrame.from_numpy(X[:8])).partitions[0]["prediction"]
            check(np.array_equal(out["prediction"], want), "the recovered server answers otherwise")
            srv.drain()
            srv.assert_steady_state()
            rec = {"failed_with": failed, "restarts": srv.health()["restarts"],
                   "recovery_ms": 1e3 * port.profiling.percentiles(f"serve.{name}.recovery")["max"],
                   "warm_dispatch_ms_first_worker": [1e3 * s for s in warm[:n]],
                   "warm_dispatch_ms_recovered_worker": [1e3 * s for s in warm[n : 2 * n]],
                   "recovered_first_request_ms": first_ms, "recovered_second_request_ms": second_ms,
                   "steady_compiles": srv.health()["steady_compiles"]}
        finally:
            srv.shutdown(drain=False)
        return rec

    def router_part(self, model, X):
        """A Router with SERVE_ROUTER_REPLICAS replicas of the KMeans model on
        the one card (shared leases), traffic through it, and a rolling swap
        under traffic to the model with its centers in reverse order: zero
        failed requests, and every answer after the cut-over the new
        model's.  The router stays up for the live index's refresh."""
        port = self.port
        S = port.serving
        t_part = time.perf_counter()
        self.router = router = S.Router(replicas=SERVE_ROUTER_REPLICAS, **SERVE_OPTS)
        router.serve("serve_km", model, allow_oversubscribe=True)
        new = port.KMeansModel(cluster_centers_=np.ascontiguousarray(model.cluster_centers_[::-1]),
                               n_cols=model.n_cols, dtype=model.dtype)
        stop, failures, answered = threading.Event(), [], [0]

        def pump(seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                i, n = int(rng.integers(0, len(X) - 64)), int(rng.integers(1, 65))
                try:
                    router.predict("serve_km", X[i : i + n], timeout_ms=60_000)
                    answered[0] += 1
                except Exception as exc:  # noqa: BLE001 - the gate counts every failure
                    failures.append(f"{type(exc).__name__}: {exc}")

        pumps = [threading.Thread(target=pump, args=(SERVE_SEED + 10 + c,)) for c in range(SERVE_CLIENTS)]
        for t in pumps:
            t.start()
        try:
            while answered[0] < 200:
                time.sleep(0.01)
            before_swap = answered[0]
            t0 = time.perf_counter()
            router.swap("serve_km", new)
            swap_s = time.perf_counter() - t0
            after = answered[0]
            while answered[0] < after + 200:
                time.sleep(0.01)
        finally:
            stop.set()
            for t in pumps:
                t.join(timeout=120)
        check(not failures, f"requests failed through the rolling swap: {failures[:3]}")
        Xc = X[:SERVE_CHECK_ROWS]
        routed = np.concatenate([router.predict("serve_km", Xc[i : i + 64])["prediction"]
                                 for i in range(0, len(Xc), 64)])
        want = new.transform(port.DataFrame.from_numpy(Xc)).partitions[0]["prediction"]
        old = model.transform(port.DataFrame.from_numpy(Xc)).partitions[0]["prediction"]
        check(np.array_equal(routed, want), "an answer after the cut-over is not the new model's")
        check(not np.array_equal(want, old), "the swapped-in model answers as the old one")
        for r in router.replicas("serve_km"):
            r.assert_steady_state()
        health = router.health()["models"]["serve_km"]
        self.parts["router"] = {
            "replicas": SERVE_ROUTER_REPLICAS, "answered_before_swap": before_swap,
            "answered_total": answered[0], "failures": len(failures), "swap_s": swap_s,
            "post_swap_rows_checked": len(Xc), "state": health["state"], "in_rotation": health["in_rotation"],
            "counters": port.profiling.counters("router.serve_km."),
            "part_s": time.perf_counter() - t_part,
        }

    @serve_timed
    def forest(self, model, X):
        def check_rows(served, rows):
            want = model.transform(self.port.DataFrame.from_numpy(rows)).partitions[0]
            for c in ("prediction", "probability", "rawPrediction"):
                check(np.array_equal(served[c], want[c]), f"served forest {c} differs from transform")
            return {"rows": len(rows), "identical": True}

        return self.serve("rf_clf", model, X, check_rows)

    @serve_timed
    def glm(self, key, model, X, cols):
        def check_rows(served, rows):
            want = model.transform(self.port.DataFrame.from_numpy(rows)).partitions[0]
            errs = {}
            for c in cols:
                g, w = np.asarray(served[c], np.float64), np.asarray(want[c], np.float64)
                check(np.allclose(g, w, rtol=SERVE_RTOL, atol=SERVE_ATOL), f"served {key} {c} differs from transform")
                errs[c] = float(np.abs(g - w).max())
            return {"rows": len(rows), "max_abs_err": errs, "rtol": SERVE_RTOL, "atol": SERVE_ATOL}

        return self.serve(key, model, X, check_rows)

    @serve_timed
    def knn(self, model, Q):
        prepared = model._staged_items[1]

        def check_rows(served, rows):
            df = self.port.DataFrame.from_numpy(rows, num_partitions=1)
            part = model.kneighbors(df)[2].partitions[0]
            idx = np.asarray(part["indices"])
            pos_of = np.empty(int(prepared.ids.max()) + 1, np.int64)
            pos_of[prepared.ids] = np.arange(len(prepared.ids))
            pos_s, pos_b = pos_of[served["indices"]], pos_of[idx]
            differ, off = near_tie_mismatches(self.torch, prepared, rows, np.arange(len(rows)), pos_s, pos_b,
                                              self.dev)
            check(off == 0, f"served kNN ids differ from kneighbors at {off} entries off near-ties")
            check(np.allclose(served["distances"], part["distances"], rtol=SERVE_RTOL, atol=0.0),
                  "served kNN distances differ from kneighbors")
            return {"rows": len(rows), "differing_entries": differ, "off_near_ties": off}

        rec = self.serve("knn", model, Q, check_rows)
        for k in ("knn_candidates", "knn_fused_merge"):
            check(rec["launches"][k] > 0, f"served kNN batches launched {k} no time")
        # B5 and B7 at the served query blocks (64-256 rows; CUDA events, not
        # counted launches)
        torch, kk = self.torch, self.kk
        sh = prepared.shards[0]
        _, m = self.knn_ops._kernel_route(model.getK(), sh.items.shape[0])
        by_bucket = {}
        for b in sorted({max(b, 64) for b in rec["buckets"]}):
            q = torch.from_numpy(Q[:b]).to(self.dev)
            vals, pos = kk.knn_candidates(sh.items, sh.norm, sh.valid, q, m)
            by_bucket[b] = {
                "pool": int(vals.shape[1] * vals.shape[2]), "m": m,
                "knn_candidates_ms": median_ms(torch, lambda: kk.knn_candidates(sh.items, sh.norm, sh.valid, q, m), 3),
                "knn_fused_merge_ms": median_ms(torch, lambda: kk.knn_fused_merge(vals, pos, model.getK()), 10),
            }
        rec["kernel_ms_by_bucket"] = by_bucket
        return rec

    @serve_timed
    def ann(self, key, model, Q):
        def check_rows(served, rows):
            part = model.kneighbors(self.port.DataFrame.from_numpy(rows, num_partitions=1))[2].partitions[0]
            differ, off = same_up_to_ties(served["distances"], served["indices"], np.asarray(part["distances"]),
                                          np.asarray(part["indices"]), SERVE_RTOL)
            check(off == 0, f"served {key} ids differ from the probed search at {off} rows off ties")
            return {"rows": len(rows), "rows_differing": differ, "off_ties": off,
                    "identical": bool(np.array_equal(served["indices"], part["indices"]))}

        rec = self.serve(key, model, Q, check_rows)
        check(rec["launches"]["knn_fused_merge"] > 0, f"served {key} batches launched knn_fused_merge no time")
        if key == "ivfpq":
            check(rec["launches"]["lut_accumulate_probed"] > 0, "served IVF-PQ batches launched B9 no time")
        return rec

    # -- the live index, refreshed into the router ---------------------------------
    @serve_timed
    def live_refresh(self, model, holder, adds, add_ids):
        """StreamingSession.refresh() of the live IVF-Flat model into the
        router (its first refresh serves it), then one add through the
        session: the added rows come back from a served search as their own
        nearest neighbours."""
        port = self.port
        t_part = time.perf_counter()

        class LiveIndexEngine:
            """A streaming engine over the live index: partial_fit adds rows
            (a chunk is (rows, ids)), finalize hands out the model, whose
            searches read the holder's latest snapshot."""

            kind = "ivfflat_live"
            rows_ingested = chunks_ingested = 0

            def partial_fit(self, chunk, y=None, weight=None):
                rows, ids = chunk
                holder.add_items(rows, ids)
                self.rows_ingested += len(rows)
                self.chunks_ingested += 1

            def finalize(self):
                return model

        session = port.StreamingSession(LiveIndexEngine(), name="serve_live_ann", router=self.router, replicas=1)
        session.refresh()
        before = self.router.predict("serve_live_ann", adds[:32])["indices"]
        session.partial_fit((adds, add_ids))
        after = self.router.predict("serve_live_ann", adds[:32])["indices"]
        check(np.array_equal(after[:, 0], add_ids[:32]), "a row added after the refresh is not its own nearest "
                                                         "neighbour in a served search")
        check(not np.isin(add_ids, before).any(), "the added ids were served before their add")
        rec = {"refreshes": session.stats()["refreshes"], "added_rows": len(adds), "served_checked_rows": 32,
               "found_after_add": True, "steady_compiles": [r.health()["steady_compiles"]
                                                            for r in self.router.replicas("serve_live_ann")]}
        self.router.unroute("serve_live_ann")
        rec["part_s"] = time.perf_counter() - t_part
        self.parts["live_index_refresh"] = rec
        return rec

    def close(self):
        if self.router is not None:
            self.router.shutdown()
            self.router = None

    def record(self, smi):
        launches = {k: sum(p.get("launches", {}).get(k, 0) for p in self.parts.values()) for k in SERVE_KERNELS}
        return {"phase": "path_serve", "rows_cut": False, "seconds": self.seconds, "budget_s": SERVE_BUDGET_S,
                "within_budget": self.seconds <= SERVE_BUDGET_S,
                "options": {**SERVE_OPTS, "min_bucket": 16, "clients": SERVE_CLIENTS, "window": SERVE_WINDOW},
                "launches": launches, "card": smi, **self.parts}


# ---------------------------------------------------------------------------
# Serving lanes: path_serve_lanes, multiplexed tenants and the autoscaled router
# ---------------------------------------------------------------------------

# (a) 16 KMeans variants (the fitted centers rolled by i rows, so each
# tenant's labels differ) on 4 resident lanes; (b) 256 OLS variants (coef x
# (1 + i/256), intercept + i) on 32 resident lanes, 8 binary logistic and 8
# PCA variants; the traffic is path_serve's with each request's tenant drawn
# Zipf (s = 1.1); (c) path's KMeans model behind a 1-replica router under an
# Autoscaler with shortened windows and cooldowns.
LANES_KM_VARIANTS, LANES_KM_RESIDENT, LANES_KM_REQUESTS = 16, 4, 1000
LANES_GLM = {"linreg": (256, 32), "logreg": (8, 8), "pca": (8, 8)}  # variants, resident lanes
LANES_GLM_REQUESTS = 500
LANES_ZIPF_S = 1.1
LANES_KM_CHECK_ROWS = 1024   # KMeans rows a tenant held against its dedicated server, in 64-row requests
LANES_GLM_CHECK_ROWS = 64    # GLM / PCA rows a tenant
LANES_BUDGET_S = 40.0        # the phase's share of the script's time limit (recorded, not a gate)
AUTOSCALE_CLIENTS = 16
# rows a replica's queue holds: 16 clients x 8 requests x 64 rows never
# overflow one replica's queue, nor reach the interactive class's shedding
AUTOSCALE_QUEUE_DEPTH = 16384
AUTOSCALE_POLICY = dict(min_replicas=1, max_replicas=3, window_s=0.5, down_window_s=1.0, up_fill=0.02, up_burn=0.1,
                        down_fill=0.01, down_occupancy=0.05, up_cooldown_s=0.2, down_cooldown_s=3.0)
AUTOSCALE_INTERVAL_S = 0.1
AUTOSCALE_STEP_S = 30.0  # the most each step (burst, idle, repair) may wait for its decision


def zipf_tenants(n_tenants, n_requests, seed):
    """The tenant ("t<i>") of each of n_requests requests, i drawn with
    probability proportional to 1 / (i + 1)^LANES_ZIPF_S."""
    p = 1.0 / np.arange(1, n_tenants + 1) ** LANES_ZIPF_S
    picks = np.random.default_rng(seed).choice(n_tenants, size=n_requests, p=p / p.sum())
    return [f"t{i}" for i in picks]


class LanePlane:
    """Phase path_serve_lanes: the models of path, path_linreg, path_logreg
    and path_pca as multiplexed tenants (MultiplexServer, each held against
    dedicated ModelServers of its variants), and path's KMeans model behind
    an autoscaled router through a burst, an idle spell and one replica
    killed with its restart budget spent."""

    def __init__(self, torch, port, wrappers, serve):
        self.torch, self.port, self.wrappers, self.serve = torch, port, wrappers, serve
        self.parts = {}
        self.seconds = 0.0
        self.launches = 0  # B1 in the phase's traffic

    def multiplexed(self, key, variants, resident, X, n_requests, check_tenants):
        """`variants` ({"t<i>": model}) behind one MultiplexServer:
        check_tenants(mux) holds every tenant against its dedicated server,
        then the Zipf traffic with every launch counter reset just before
        and read just after."""
        port = self.port
        S = port.serving
        name = f"lanes_{key}"
        t_part = time.perf_counter()
        t0 = time.perf_counter()
        mux = S.MultiplexServer(name, variants, resident_lanes=resident, **SERVE_OPTS)
        warm_s = time.perf_counter() - t0
        try:
            rec = {"variants": len(variants), "resident_lanes": mux.lanes()["n_lanes"], "requests": n_requests,
                   "warm_s": warm_s}
            t0 = time.perf_counter()
            rec["check"] = check_tenants(mux)
            rec["check"]["seconds"] = time.perf_counter() - t0
            port.profiling.reset_durations(f"serve.{name}.")
            before = port.profiling.counters(f"serving.{name}.")
            self.torch.cuda.synchronize()
            reset_launches(self.wrappers)
            tenants = zipf_tenants(len(variants), n_requests, SERVE_SEED + 20)
            rows, seconds = serve_traffic(mux, X, n_requests, SERVE_SEED + 21, model_ids=tenants)
            launches = read_launches(self.wrappers)["min_dist_argmin"]
            moved = port.profiling.counter_deltas(before, f"serving.{name}.")
            stats = mux.stats()
            mux.drain()
            mux.assert_steady_state()
        finally:
            mux.shutdown(drain=False)
        batches = moved.get(f"serving.{name}.batches", 0)
        lat, page = stats["latency"], stats["lanes"]["page_in_latency"]
        dedicated = self.serve.parts.get(key, {}).get("rows_per_s")
        rec.update({
            "rows": rows, "seconds": seconds, "rows_per_s": rows / seconds, "dedicated_rows_per_s": dedicated,
            "latency_ms": {q: 1e3 * lat[q] for q in ("p50", "p95", "p99", "max")},
            "batches": batches, "mean_batch_rows": rows / max(batches, 1),
            "mean_requests_per_batch": stats["batch_occupancy"].get("mean"),
            "dispatch_ms_by_bucket": {b: {"p50": 1e3 * d["p50"], "count": d["count"]}
                                      for b, d in stats["dispatch_by_bucket"].items() if d},
            "tenants_served": len(set(tenants)),
            "min_dist_argmin_launches": launches,
            "page_in": moved.get(f"serving.{name}.lanes.page_in", 0),
            "hits": moved.get(f"serving.{name}.lanes.hits", 0),
            "evictions": moved.get(f"serving.{name}.lanes.evictions", 0),
            "page_in_ms": {q: 1e3 * page[q] for q in ("p50", "p99", "max")} if page else None,
            "steady_compiles": stats["steady_compiles"],
            "counters": {k: v for k, v in moved.items() if ".tenant." not in k},
        })
        check(moved.get(f"serving.{name}.requests", 0) == n_requests, f"{name}: requests {moved}")
        check(not moved.get(f"serving.{name}.errors"), f"{name}: dispatch errors {moved}")
        check(stats["steady_compiles"] == 0, f"{name}: steady-state warm-ups {stats['steady_compiles']}")
        rec["part_s"] = time.perf_counter() - t_part
        return rec

    def done(self, key, rec):
        """Keep a part's record and print it at once (a later part's failure
        leaves the earlier parts' records in the log)."""
        self.parts[key] = rec
        emit({"phase": "path_serve_lanes", "part": key, **rec})
        return rec

    # -- (a) KMeans lanes at full width --------------------------------------------
    @serve_timed
    def kmeans(self, model, X):
        port = self.port
        S = port.serving
        C = np.asarray(model.cluster_centers_)
        variants = {f"t{i}": port.KMeansModel(cluster_centers_=np.ascontiguousarray(np.roll(C, i, axis=0)),
                                              n_cols=model.n_cols, dtype=model.dtype)
                    for i in range(LANES_KM_VARIANTS)}
        Xc = X[:LANES_KM_CHECK_ROWS]

        def check_tenants(mux):
            """Each tenant's 1,024 rows in 64-row requests against a
            dedicated ModelServer of its variant: labels bit for bit."""
            differ, labels = 0, {}
            for mid, m in variants.items():
                got = served_rows(mux, Xc, model_id=mid)["prediction"]
                ded = S.ModelServer(f"lanes_km_ded_{mid}", m, **SERVE_OPTS)
                try:
                    want = served_rows(ded, Xc)["prediction"]
                finally:
                    ded.shutdown(drain=False)
                differ += int((got != want).sum())
                labels[mid] = got
            check(differ == 0, f"multiplexed KMeans labels differ from the dedicated servers' at {differ} rows")
            check(not np.array_equal(labels["t0"], labels["t1"]), "two tenants' variants answer alike")
            return {"tenants": len(variants), "rows_a_tenant": len(Xc), "differing_rows": differ}

        rec = self.multiplexed("kmeans", variants, LANES_KM_RESIDENT, X, LANES_KM_REQUESTS, check_tenants)
        check(rec["min_dist_argmin_launches"] > 0, "multiplexed KMeans batches launched min_dist_argmin no time")
        check(rec["page_in"] > 0, "the KMeans traffic paged no lane in")
        rec["lanes_per_batch"] = rec["min_dist_argmin_launches"] / max(rec["batches"], 1)
        rec["lane_bytes"] = int(C.shape[0] * C.shape[1] * 4)
        self.launches += rec["min_dist_argmin_launches"]
        return self.done("kmeans", rec)

    # -- (b) GLM and PCA lanes at D 3,000 --------------------------------------------
    @serve_timed
    def glm(self, key, model, X):
        port = self.port
        S = port.serving
        n, resident = LANES_GLM[key]
        if key == "linreg":
            variants = {f"t{i}": port.LinearRegressionModel(
                coef_=np.asarray(model.coef_) * (1.0 + i / n), intercept_=float(model.intercept_) + i,
                n_cols=model.n_cols, dtype=model.dtype) for i in range(n)}
            cols = ["prediction"]
        elif key == "logreg":
            variants = {f"t{i}": port.LogisticRegressionModel(
                coef_=np.asarray(model.coef_) * (1.0 + i / n), intercept_=np.asarray(model.intercept_) + i / n,
                classes_=np.asarray(model.classes_), n_cols=model.n_cols, dtype=model.dtype) for i in range(n)}
            cols = ["prediction", "probability", "rawPrediction"]
        else:
            variants = {}
            for i in range(n):
                v = port.PCAModel(mean_=np.asarray(model.mean_), components_=np.asarray(model.components_) * (1.0 + i / n),
                                  explained_variance_=np.asarray(model.explained_variance_),
                                  explained_variance_ratio_=np.asarray(model.explained_variance_ratio_),
                                  singular_values_=np.asarray(model.singular_values_), n_cols=model.n_cols,
                                  dtype=model.dtype)
                v.setOutputCol(model.getOrDefault("outputCol"))
                variants[f"t{i}"] = v
            cols = [model.getOrDefault("outputCol")]
        Xc = X[:LANES_GLM_CHECK_ROWS]

        def check_tenants(mux):
            """Each tenant's 64 rows against a dedicated ModelServer of its
            variant (not warmed: a comparator) at rtol = atol = 1e-5."""
            futs = {mid: mux.submit(Xc, model_id=mid) for mid in variants}
            # every multiplexed answer first: the comparators' first
            # dispatches then overlap no dispatch of the multiplexed server
            outs = {mid: fut.result(timeout=600) for mid, fut in futs.items()}
            err = {c: 0.0 for c in cols}
            for mid, got in outs.items():
                ded = S.ModelServer(f"lanes_{key}_ded_{mid}", variants[mid], max_batch=SERVE_OPTS["max_batch"],
                                    max_wait_ms=0.5, warm=False)
                try:
                    want = ded.predict(Xc)
                finally:
                    ded.shutdown(drain=False)
                for c in cols:
                    g, w = np.asarray(got[c], np.float64), np.asarray(want[c], np.float64)
                    check(np.allclose(g, w, rtol=SERVE_RTOL, atol=SERVE_ATOL),
                          f"multiplexed {key} tenant {mid} {c} differs from its dedicated server")
                    err[c] = max(err[c], float(np.abs(g - w).max()))
            return {"tenants": len(variants), "rows_a_tenant": len(Xc), "max_abs_err": err, "rtol": SERVE_RTOL,
                    "atol": SERVE_ATOL}

        return self.done(key, self.multiplexed(key, variants, resident, X, LANES_GLM_REQUESTS, check_tenants))

    # -- (c) autoscaling the KMeans router --------------------------------------------
    @serve_timed
    def autoscale(self, model, X):
        """A 1-replica router of the KMeans model under an Autoscaler (ticks
        every AUTOSCALE_INTERVAL_S): a burst of AUTOSCALE_CLIENTS clients
        until the set reaches max_replicas, idle until a scale_down, then
        one replica killed at its next dispatch through the serving.dispatch
        fault site with SRML_SERVE_MAX_RESTARTS=0 under two clients until
        the repair.  Zero failed requests; the journal holds scale_up,
        scale_down and repair; no replica warms up in its steady state."""
        port = self.port
        S, faults = port.serving, port.parallel.faults
        P = port.profiling
        name = "lanes_as_km"
        t_part = time.perf_counter()
        router = S.Router(replicas=1, queue_depth=AUTOSCALE_QUEUE_DEPTH, **SERVE_OPTS)
        autoscaler = None
        failures, answered, seen = [], [0], {}
        stop = threading.Event()

        def settle(window):
            for fut in window:
                try:
                    fut.result(timeout=120)
                    answered[0] += 1
                except Exception as exc:  # noqa: BLE001 - the gate counts every failure
                    failures.append(f"{type(exc).__name__}: {exc}")
            window.clear()

        def pump(seed):
            """One client: requests of 1-64 rows, up to SERVE_WINDOW outstanding."""
            rng = np.random.default_rng(seed)
            window = []
            try:
                while not stop.is_set():
                    i, n = int(rng.integers(0, len(X) - 64)), int(rng.integers(1, 65))
                    window.append(router.submit(name, X[i : i + n], timeout_ms=60_000))
                    if len(window) >= SERVE_WINDOW:
                        settle(window)
            except Exception as exc:  # noqa: BLE001 - a refused submit is a failed request too
                failures.append(f"{type(exc).__name__}: {exc}")
            settle(window)

        def watch_rotation():
            """The time each replica first shows in rotation (the replica is
            held, so its id is never reused)."""
            while not stop_watch.is_set():
                now = P.now()
                for r in router.replicas(name):
                    seen.setdefault(id(r), (r, now))
                stop_watch.wait(0.002)

        def decided(decision):
            return any(e["decision"] == decision for e in autoscaler.journal())

        def run_until(pred, clients, seed):
            stop.clear()
            pumps = [threading.Thread(target=pump, args=(seed + c,)) for c in range(clients)]
            for t in pumps:
                t.start()
            try:
                deadline = time.perf_counter() + AUTOSCALE_STEP_S
                while not pred() and time.perf_counter() < deadline:
                    time.sleep(0.005)
            finally:
                stop.set()
                for t in pumps:
                    t.join(timeout=600)
            return pred()

        stop_watch = threading.Event()
        watcher = threading.Thread(target=watch_rotation)
        try:
            router.serve(name, model, allow_oversubscribe=True)
            first = router.replicas(name)[0]
            watcher.start()
            autoscaler = S.Autoscaler(router, policy=S.AutoscalePolicy(**AUTOSCALE_POLICY),
                                      interval_s=AUTOSCALE_INTERVAL_S, names=[name]).start()
            reset_launches(self.wrappers)
            t0 = time.perf_counter()
            up = run_until(lambda: len(router.replicas(name)) >= AUTOSCALE_POLICY["max_replicas"],
                           AUTOSCALE_CLIENTS, SERVE_SEED + 40)
            burst_s = time.perf_counter() - t0
            check(decided("scale_up"), f"no scale_up in the burst: {autoscaler.journal()}")
            peak = len(router.replicas(name))
            t0 = time.perf_counter()
            check(run_until(lambda: decided("scale_down"), 0, 0), f"no scale_down when idle: {autoscaler.journal()}")
            idle_s = time.perf_counter() - t0
            survivors = router.replicas(name)
            check(len(survivors) >= 2, f"{len(survivors)} replica(s) left to reroute a killed one's requests")
            victim = survivors[0]
            series = f"serve.{victim.name}.dispatch"
            n_before = len(P.durations(series).get(series, []))
            os.environ["SRML_SERVE_MAX_RESTARTS"] = "0"
            os.environ[faults.FAULTS_ENV] = f"serving.dispatch:tag={victim.name}:call=1:action=kill"
            faults.reload()
            try:
                t0 = time.perf_counter()
                check(run_until(lambda: decided("repair"), 2, SERVE_SEED + 60),
                      f"no repair of the killed replica: {autoscaler.journal()}")
                repair_s = time.perf_counter() - t0
            finally:
                del os.environ[faults.FAULTS_ENV], os.environ["SRML_SERVE_MAX_RESTARTS"]
                faults.reload()
            for i in range(8):  # the repaired replica's first dispatches (it holds the victim's slot)
                router.predict(name, X[64 * i : 64 * i + 64], timeout_ms=60_000)
            launches = read_launches(self.wrappers)["min_dist_argmin"]
            journal = autoscaler.journal()
            final = router.replicas(name)
            check(victim not in final and victim.state() == S.UNHEALTHY, "the killed replica was not replaced")
            for r in final:
                check(r.state() == S.READY, f"{r.name} is {r.state()} after the repair")
                r.assert_steady_state()
            replica_names = sorted({r.name for r, _t in seen.values()})
            steady = {n: P.counter(f"serving.{n}.steady_compiles") for n in replica_names}
            check(not any(steady.values()), f"steady-state warm-ups on a replica: {steady}")
            check(not failures, f"{len(failures)} client requests failed: {failures[:3]}")
        finally:
            stop.set()
            stop_watch.set()
            if watcher.is_alive():
                watcher.join(timeout=60)
            if autoscaler is not None:
                autoscaler.stop()
            router.shutdown(drain=False)
        # scale-up latency: each scale_up's decision (its tick's time) to its
        # replica's first sight in rotation
        ups = [e for e in journal if e["decision"] == "scale_up"]
        joined = sorted(t for r, t in seen.values() if r is not first)
        up_latency = [1e3 * (t - e["t"]) for e, t in zip(ups, joined)]

        def first_ms(n, kind, start=0):
            series = f"serve.{n}.{kind}"
            return [1e3 * d for d in P.durations(series).get(series, [])[start : start + 5]]

        new_first = {n: {"warm_dispatch_ms": first_ms(n, "warm_dispatch"), "dispatch_ms": first_ms(n, "dispatch")}
                     for n in replica_names if n != first.name}
        new_first[f"{victim.name} (repaired)"] = {"dispatch_ms": first_ms(victim.name, "dispatch", n_before)}
        self.launches += launches
        rec = {"policy": AUTOSCALE_POLICY, "interval_s": AUTOSCALE_INTERVAL_S, "clients": AUTOSCALE_CLIENTS,
               "queue_depth": AUTOSCALE_QUEUE_DEPTH, "reached_max": up, "peak_replicas": peak,
               "burst_s": burst_s, "idle_s": idle_s, "repair_s": repair_s,
               "journal": [{k: e[k] for k in ("t", "decision", "from_replicas", "to_replicas", "reason")}
                           for e in journal],
               "scale_up_latency_ms": up_latency, "new_replica_first_dispatch_ms": new_first,
               "answered": answered[0], "failed": len(failures), "min_dist_argmin_launches": launches,
               "steady_compiles": steady, "final_replicas": [r.name for r in final],
               "counters": {k: v for k, v in P.counters(f"autoscale.{name}.").items()},
               "router_counters": P.counters(f"router.{name}."), "part_s": time.perf_counter() - t_part}
        return self.done("autoscale", rec)

    def record(self, smi):
        return {"phase": "path_serve_lanes", "rows_cut": False, "seconds": self.seconds, "budget_s": LANES_BUDGET_S,
                "within_budget": self.seconds <= LANES_BUDGET_S,
                "options": {**SERVE_OPTS, "min_bucket": 16, "clients": SERVE_CLIENTS, "window": SERVE_WINDOW,
                            "zipf_s": LANES_ZIPF_S},
                "launches": {"min_dist_argmin": self.launches}, "card": smi,
                "lanes_per_kmeans_batch": self.parts.get("kmeans", {}).get("lanes_per_batch"),
                "part_s": {key: rec["part_s"] for key, rec in self.parts.items()}}


# ---------------------------------------------------------------------------
# Fits on a mesh: the row-sharded ingest and the fit reductions over
# shards, on four shards of the one card
# ---------------------------------------------------------------------------

# path_fit_mesh: each batch cell's estimator on use_device(["cuda:0"] * 4)
# with num_workers 4, right after the path that makes its rows, held
# against that path's one-shard fit or float64 reference.  KMeans (the same
# init, its draws over global rows) against path's model: n_iter equal,
# inertia within 1e-4 relative, at most MESH_KM_FLIP_SHARE of the labels
# differing (near-tie rows the rounding of the shards' sums flips), and
# every center those rows do not touch within the JAX package's mesh gate
# (tests/test_kmeans.py:96-104, atol 1e-2);
# PCA at path_pca's float64 gates; OLS within LINREG_RTOL of the float64
# solve; logistic held-out accuracy above HOLDOUT_ACCURACY and coefficients
# within CV_LOGISTIC_ATOL of path_logreg's; the RF regressor at its widths
# (3000 features, 128 bins, depth 6, "onethird") on the scatter engine, its
# tree count cut from 30 (MESH_RF_TREES): the engine's histogram pass grows
# with the trees, and the whole script has a time limit.
MESH_DEVICES = ("cuda:0",) * MESH_SHARDS
MESH_KM_CENTER_ATOL, MESH_KM_INERTIA_RTOL, MESH_KM_FLIP_SHARE = 1e-2, 1e-4, 1e-4
MESH_RF_TREES = 8
MESH_PHASES = ("path_fit_mesh", "mesh_card_vs_cpu")
# mesh_card_vs_cpu: 65,536 x 256 integer rows (16,384 x 64 for the forest),
# each fit on 4 shards of the card, 1 shard of the card and 8 shards of the
# CPU.  Values small enough that every sum of a statistic stays an integer
# under 2^24: KMeans rows around 8 blobs (centers and inertia exact given one
# init), PCA / linear rows in [-2, 2] with y in [-8, 8], forest targets in
# 0..7 (bootstrap counts times y^2 sum under 2^24)
MCVC_ROWS, MCVC_COLS, MCVC_FOREST_ROWS, MCVC_FOREST_COLS, MCVC_SEED = 65536, 256, 16384, 64, 91
MCVC_KMEANS = dict(k=8, maxIter=20, seed=3)
MCVC_FOREST = dict(numTrees=4, maxDepth=14, maxBins=32, featureSubsetStrategy="onethird", seed=5)
MCVC_LOGREG = dict(regParam=1e-3, maxIter=100, tol=1e-6)
# (name, device list, num_workers) of the three ways each fit runs
MCVC_CONFIGS = (("card_4_shards", list(MESH_DEVICES), MESH_SHARDS), ("card_1_shard", ["cuda:0"], 1),
                ("cpu_8_shards", ["cpu"] * 8, 8))


def mesh_fit(torch, port, est, df, wrappers):
    """est.fit(df) on the card's four shards, cold: (model, fit seconds,
    ingest seconds, peak device bytes over the bytes before, launches,
    exchange bytes by section, link bytes)."""
    port.clear_fit_cache()
    port.profiling.reset_phase_times()
    port.profiling.reset_counters("exchange.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches(wrappers)
    with port.device.use_device(list(MESH_DEVICES)):
        t0 = time.perf_counter()
        model = est.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    total, per = port.parallel.exchange.byte_totals()
    rec = {"fit_s": fit_s, "ingest_s": port.profiling.phase_times().get("core.ingest"),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() - base,
           "launches_fit": read_launches(wrappers), "exchange_bytes": total, "exchange_bytes_by_section": per,
           "exchange_calls": {k: v for k, v in port.profiling.counters("exchange.").items() if k.endswith(".calls")},
           "link_bytes": port.parallel.exchange.link_totals(), "shards": MESH_SHARDS}
    return model, rec


def keep_mesh_model(models, name, model):
    """Hold a path_fit_mesh model for path_fit_ranks (models None: not
    run)."""
    if models is not None:
        models[name] = model


def mesh_kmeans_part(torch, port, nc, wrappers, X, single, models=None):
    """path_fit_mesh's KMeans part: the flagship on path's rows on 4 shards;
    centers and inertia against path's one-shard model; transform (B1 a
    partition)."""
    df = port.DataFrame.from_numpy(X, num_partitions=PARTITIONS)
    est = port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED, num_workers=MESH_SHARDS)
    model, rec = mesh_fit(torch, port, est, df, wrappers)
    keep_mesh_model(models, "kmeans", model)
    port.clear_fit_cache()
    reset_launches(wrappers)
    with port.device.use_device(list(MESH_DEVICES)):
        t0 = time.perf_counter()
        labels = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
        transform_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    # the same init (its draws index global rows) and the same Lloyd steps:
    # the two fits part only where rounding of the sums over shards flips a
    # near-tie row between two centers, which moves those two centers only
    single_labels = np.concatenate([p["prediction"] for p in single.transform(df).partitions])
    flipped = labels != single_labels
    touched = np.union1d(labels[flipped], single_labels[flipped])
    center_err = np.abs(model.cluster_centers_ - single.cluster_centers_).max(axis=1)
    untouched = np.setdiff1d(np.arange(K), touched)
    rec.update(
        rows=ROWS, cols=COLS, k=K, max_iter=MAX_ITER, init_mode="random", n_iter=model.n_iter_,
        inertia=model.inertia_, single_shard_inertia=single.inertia_, single_shard_n_iter=single.n_iter_,
        inertia_rel_err=abs(model.inertia_ / single.inertia_ - 1.0),
        centers_max_abs_err=float(center_err.max()),
        untouched_centers_max_abs_err=float(center_err[untouched].max()),
        transform_s=transform_s, transform_launches=launches,
        labels_differing_from_single_shard=int(flipped.sum()), centers_touched_by_them=int(touched.size),
        gates={"untouched_centers_atol": MESH_KM_CENTER_ATOL, "inertia_rtol": MESH_KM_INERTIA_RTOL,
               "differing_labels_share": MESH_KM_FLIP_SHARE},
    )
    check(launches["min_dist_argmin"] == PARTITIONS, f"transform launched B1 {launches['min_dist_argmin']} times")
    check(int(labels.min()) >= 0 and int(labels.max()) < K, "labels out of range")
    check(rec["untouched_centers_max_abs_err"] <= MESH_KM_CENTER_ATOL and rec["inertia_rel_err"] <= MESH_KM_INERTIA_RTOL
          and flipped.mean() <= MESH_KM_FLIP_SHARE and model.n_iter_ == single.n_iter_,
          f"KMeans on 4 shards against path's one shard: {rec}")
    return rec


def mesh_pca_part(torch, port, wrappers, X, reference, models=None):
    """path_fit_mesh's PCA part: PCA(k=3) on path_pca's rows on 4 shards, at
    path_pca's gates against its float64 reference."""
    mean, comps, ratio, sv = reference
    df = port.DataFrame.from_numpy(X, num_partitions=GLM_PARTITIONS)
    model, rec = mesh_fit(torch, port, port.PCA(k=PCA_K, num_workers=MESH_SHARDS), df, wrappers)
    keep_mesh_model(models, "pca", model)
    errs = {
        "mean_max_abs_err": float(np.abs(model.mean_ - mean).max()),
        "components_max_abs_err": float(np.abs(model.components_ - comps).max()),
        "ratio_max_abs_err": float(np.abs(model.explained_variance_ratio_ - ratio).max()),
        "singular_values_max_rel_err": float(np.abs(model.singular_values_ / sv - 1.0).max()),
    }
    rec.update(rows=GLM_ROWS, cols=GLM_COLS, k=PCA_K, errors_vs_float64=errs)
    check(errs["mean_max_abs_err"] <= PCA_MEAN_ATOL and errs["components_max_abs_err"] <= PCA_COMP_ATOL
          and errs["ratio_max_abs_err"] <= PCA_RATIO_ATOL and errs["singular_values_max_rel_err"] <= PCA_SV_RTOL,
          f"PCA on 4 shards against float64: {errs}")
    return rec


def mesh_linreg_part(torch, port, wrappers, X, y, reference, models=None):
    """path_fit_mesh's OLS part on path_linreg's rows on 4 shards, within
    LINREG_RTOL of path_linreg's float64 solve."""
    b64, b0_64, scale = reference
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], y[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    model, rec = mesh_fit(torch, port, port.LinearRegression(num_workers=MESH_SHARDS), df, wrappers)
    keep_mesh_model(models, "linreg", model)
    rec.update(rows=GLM_ROWS, cols=GLM_COLS, fit="ols",
               coef_max_rel_err_vs_float64=float(np.abs(model.coef_ - b64).max()) / scale,
               intercept_rel_err_vs_float64=abs(model.intercept_ - b0_64) / scale)
    check(rec["coef_max_rel_err_vs_float64"] <= LINREG_RTOL and rec["intercept_rel_err_vs_float64"] <= LINREG_RTOL,
          f"OLS on 4 shards against the float64 solve: {rec}")
    return rec


def mesh_logreg_part(torch, port, wrappers, X, y, single, models=None):
    """path_fit_mesh's binary logistic part on path_logreg's rows on 4
    shards: held-out accuracy, coefficients against path_logreg's model."""
    yb = (y > 0).astype(np.float32)
    df = port.DataFrame.from_numpy(X[:GLM_ROWS], yb[:GLM_ROWS], num_partitions=GLM_PARTITIONS)
    port.profiling.reset_counters("lbfgs.")
    model, rec = mesh_fit(torch, port, port.LogisticRegression(**LOGREG, num_workers=MESH_SHARDS), df, wrappers)
    keep_mesh_model(models, "logreg", model)
    solver = port.profiling.counters("lbfgs.")
    acc = float((concat_col(model.transform(port.DataFrame.from_numpy(X[GLM_ROWS:], num_partitions=1)),
                            "prediction") == yb[GLM_ROWS:]).mean())
    rec.update(rows=GLM_ROWS, cols=GLM_COLS, params=LOGREG, holdout_accuracy=acc,
               lbfgs_iterations=solver.get("lbfgs.iterations"), lbfgs_evaluations=solver.get("lbfgs.evaluations"),
               single_shard_num_iters=single.num_iters, num_iters=model.num_iters,
               coef_max_abs_err_vs_single_shard=float(np.abs(model.coef_ - single.coef_).max()),
               intercept_abs_err_vs_single_shard=float(np.abs(model.intercept_ - single.intercept_).max()))
    check(acc > HOLDOUT_ACCURACY, f"logistic on 4 shards: held-out accuracy {acc}")
    check(rec["coef_max_abs_err_vs_single_shard"] <= CV_LOGISTIC_ATOL
          and rec["intercept_abs_err_vs_single_shard"] <= CV_LOGISTIC_ATOL,
          f"logistic on 4 shards against path_logreg's model: {rec}")
    return rec


def mesh_rf_part(torch, port, wrappers, X, y, models=None):
    """path_fit_mesh's RandomForestRegressor part on path_rf_reg's rows on 4
    shards, through the scatter engine: B2 once a shard, finite
    predictions, held-out R^2 > 0, the engine's seconds a level."""
    df = port.DataFrame.from_numpy(X[:RF_ROWS], y[:RF_ROWS], num_partitions=RF_PARTITIONS)
    params = dict(RF_REG, numTrees=MESH_RF_TREES)
    port.profiling.reset_events()
    model, rec = mesh_fit(torch, port, port.RandomForestRegressor(**params, num_workers=MESH_SHARDS), df, wrappers)
    levels = [dict(meta) for _, meta in port.profiling.events("forest.engine.level")]
    with port.device.use_device(list(MESH_DEVICES)):
        hold = np.concatenate([p["prediction"] for p in model.transform(
            port.DataFrame.from_numpy(X[RF_ROWS:], num_partitions=1)).partitions])
    y_hold = y[RF_ROWS:]
    r2 = float(1.0 - ((hold - y_hold) ** 2).mean() / y_hold.var())
    phases = port.profiling.phase_stats("forest.engine.")
    rec.update(rows=RF_ROWS, cols=X.shape[1], params={k: v for k, v in params.items()}, tree_count_cut_from=30,
               holdout_r2=r2, levels=levels, engine_phases=phases,
               launches_expected={"bin_features_fm": MESH_SHARDS})
    check(rec["launches_fit"]["bin_features_fm"] == MESH_SHARDS,
          f"the mesh forest launched B2 {rec['launches_fit']['bin_features_fm']} times, not once a shard")
    check(sum(rec["launches_fit"][k] for k in ("node_histograms_mma", "node_histograms_atomic",
                                               "node_histograms_bucketed")) == 0,
          "the scatter engine launched a histogram kernel")
    check(np.isfinite(hold).all() and r2 > 0.0, f"mesh forest: held-out R^2 {r2}")
    return rec


def run_fit_mesh_path(parts, seconds):
    """The path_fit_mesh record: each part's record (each emitted when it
    ran) and the seconds of the parts together."""
    return {"phase": "path_fit_mesh", "shards": MESH_SHARDS, "devices": list(MESH_DEVICES),
            "parts": parts, "parts_s": seconds, "seconds": sum(seconds.values())}


# path_fit_ranks: 2 ranks x 2 shards of the card = path_fit_mesh's 4 shards
RANKS = 2
RANK_SHARDS = MESH_SHARDS // RANKS
# the forest is mesh_card_vs_cpu's integer forest (rf_int), not the
# flagship regressor: with the flagship the whole script passed 1,100 s
# (1,151 s), and its 10-GB histogram psum through gloo was the phase's
# largest cost (ROADMAP perf item 17)
RANKS_FITS = ("kmeans", "pca", "linreg", "logreg", "rf_int")
RANKS_KNN_QUERIES = 4096   # path_knn's first queries, 2,048 a rank
KNN_TIE_SLACK = 8          # the reference search past k that lists every item at the k-th distance
RANKS_TRANSFORM_ROWS = 65536  # path's first rows, through the parent's KMeans model
RANKS_KILL_S = 30.0        # the killed rank's typed error on rank 0, at most
RANKS_KILL_ROWS, RANKS_KILL_COLS = 4096, 64
RANKS_WORKER_TIMEOUT_S = 420
RANKS_KILL_FAULT = "runner.fit:rank=1:action=die"


def ranks_job_dir():
    """A fresh job directory for path_fit_ranks under the checkout's ignored
    build/ tree."""
    job = os.path.join(REPO, "build", "ranks_job")
    shutil.rmtree(job, ignore_errors=True)
    os.makedirs(job)
    return job


def ranks_estimator(port, name):
    """path_fit_mesh's estimator of `name`, without num_workers (a session's
    mesh holds every device of the rank)."""
    return {
        "kmeans": lambda: port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED),
        "pca": lambda: port.PCA(k=PCA_K),
        "linreg": lambda: port.LinearRegression(),
        "logreg": lambda: port.LogisticRegression(**LOGREG),
        "rf_int": lambda: port.RandomForestRegressor(**MCVC_FOREST),
        "kill": lambda: port.LinearRegression(),
    }[name]()


def rank_range(rows, rank, nranks):
    return rank * rows // nranks, (rank + 1) * rows // nranks


def ranks_partition(name, rank, nranks, labels, cache):
    """This rank's share of `name`'s rows as one partition, made from the
    generators' own streams (stream_rows) with the labels the paths saved in
    the directory `labels`: rank r holds rows r * n / nranks .. (r + 1) * n / nranks of the
    path's n rows ("knn": this rank's items and queries of path_knn, with
    their ids).  The GLM rows are made once for OLS and logistic (held in
    `cache` until another dataset is made)."""
    if name not in ("linreg", "logreg"):
        cache.clear()
    if name == "kmeans":
        return {"features": blobs(ROWS, COLS, K, SEED, part=rank_range(ROWS, rank, nranks))}
    if name == "pca":
        return {"features": low_rank_data(GLM_ROWS, GLM_COLS, PCA_RANK, PCA_SEED,
                                          part=rank_range(GLM_ROWS, rank, nranks))}
    if name in ("linreg", "logreg"):
        lo, hi = rank_range(GLM_ROWS, rank, nranks)
        y = np.load(os.path.join(labels, "y_glm.npy"), mmap_mode="r")[lo:hi]
        y = (y > 0).astype(np.float32) if name == "logreg" else np.array(y)
        if "glm" not in cache:
            cache["glm"] = normal_data(GLM_ROWS + GLM_HOLDOUT, GLM_COLS, GLM_SEED, part=(lo, hi))
        return {"features": cache["glm"], "label": y}
    if name == "knn":
        lo, hi = rank_range(KNN_ITEMS, rank, nranks)
        qlo, qhi = rank_range(RANKS_KNN_QUERIES, rank, nranks)
        return (normal_data(KNN_ITEMS, COLS, KNN_ITEM_SEED, part=(lo, hi)), np.arange(lo, hi, dtype=np.int64),
                normal_data(KNN_QUERIES, COLS, KNN_QUERY_SEED, part=(qlo, qhi)), np.arange(qlo, qhi, dtype=np.int64))
    if name == "rf_int":
        lo, hi = rank_range(MCVC_FOREST_ROWS, rank, nranks)
        _, _, Xf, yf = mcvc_rows()
        return {"features": Xf[lo:hi], "label": yf[lo:hi]}
    rng = np.random.default_rng(rank)
    X = rng.standard_normal((RANKS_KILL_ROWS, RANKS_KILL_COLS), dtype=np.float32)
    return {"features": X, "label": X.sum(axis=1)}


def ranks_worker(torch, rank, nranks, job):
    """One rank of path_fit_ranks (chip_smoke.py --rank r --nranks n --job
    DIR): the job's fits through one DistributedFitSession over a
    FileControlPlane, then distributed_kneighbors over a TcpControlPlane;
    its record in DIR/rank<r>.json, rank 0's model attributes in
    DIR/attrs_<fit>.json, its kNN results as .npy files.  Returns 3 when
    the session ends in a typed control-plane error (the killed-rank case)."""
    import spark_rapids_ml_tpu_torch as port
    from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
    from spark_rapids_ml_tpu_torch.ops.knn import distributed_kneighbors
    from spark_rapids_ml_tpu_torch.parallel import exchange
    from spark_rapids_ml_tpu_torch.parallel.context import ControlPlaneTimeout, RemoteRankError
    from spark_rapids_ml_tpu_torch.parallel.mesh import get_mesh
    from spark_rapids_ml_tpu_torch.parallel.netplane import bootstrap_tcp_plane
    from spark_rapids_ml_tpu_torch.parallel.runner import FileControlPlane, distributed_session

    with open(os.path.join(job, "spec.json")) as f:
        spec = json.load(f)
    port.device.use_device(spec["devices"][rank])
    wrappers = kernel_wrappers()
    out = {"rank": rank, "devices": spec["devices"][rank], "fits": {}, "knn": {}}

    def save():
        with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)

    cache = {}

    def made(name):
        t0 = time.perf_counter()
        return ranks_partition(name, rank, nranks, spec["labels"], cache), time.perf_counter() - t0

    # the next fit's rows (after the last fit, the kNN rows) are made on a
    # thread while this fit runs; the first while the session starts
    maker = ThreadPoolExecutor(1)
    names = spec["fits"]
    pending = maker.submit(made, names[0])
    knn_rows = None
    t_fit = time.perf_counter()
    try:
        plane = FileControlPlane(os.path.join(job, "cp_fit"), rank, nranks)
        with distributed_session(rank, nranks, plane) as session:
            out["context"] = session.context.phases
            for j, name in enumerate(names):
                t0 = time.perf_counter()
                part, gen_s = pending.result()
                wait_s = time.perf_counter() - t0
                if j + 1 < len(names):
                    pending = maker.submit(made, names[j + 1])
                elif spec.get("knn"):
                    knn_rows = maker.submit(made, "knn")
                port.profiling.reset_counters("exchange.")
                port.profiling.reset_counters("cp.")
                reset_launches(wrappers)
                torch.cuda.synchronize()
                t_fit = time.perf_counter()
                attrs = session.fit(ranks_estimator(port, name), [part])
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t_fit
                del part
                counters = port.profiling.counters("exchange.")
                out["fits"][name] = {
                    "gen_s": gen_s, "gen_wait_s": wait_s, "fit_s": fit_s,
                    "ingest_s": session.last_fit["build_inputs_s"],
                    "launches": read_launches(wrappers), "exchange_bytes_by_section": exchange.byte_totals()[1],
                    "dcn_bytes_by_section": {k[len("exchange."):-len(".dcn_bytes")]: v for k, v in counters.items()
                                             if k.endswith(".dcn_bytes")},
                    "control_plane": port.profiling.counters("cp."),
                }
                if rank == 0:
                    with open(os.path.join(job, f"attrs_{name}.json"), "w") as f:
                        json.dump(attrs, f)
    except (RemoteRankError, ControlPlaneTimeout) as exc:
        out["error"] = {"type": type(exc).__name__, "message": str(exc), "seconds": time.perf_counter() - t_fit}
        save()
        maker.shutdown(cancel_futures=True)
        return 3
    if knn_rows is not None:
        plane = bootstrap_tcp_plane(os.path.join(job, "cp_knn"), rank, nranks)
        (items, ids, Q, qids), gen_s = knn_rows.result()
        out["knn_rows_made_s"] = gen_s
        mesh = get_mesh(None)
        search = knn_ops.knn_search_prepared
        for route in ("ring", "gather"):
            for prefix in ("exchange.", "cp.", "knn.exchange_route."):
                port.profiling.reset_counters(prefix)
            reset_launches(wrappers)
            search.flagged_rows = search.rerun_rows = 0
            plane.barrier()  # the ranks start the route together
            t0 = time.perf_counter()
            ((dist, idx),) = distributed_kneighbors([(items, ids)], [(Q, qids)], KNN_K, rank, nranks, plane,
                                                    mesh=mesh, exchange=route)
            seconds = time.perf_counter() - t0
            np.save(os.path.join(job, f"knn_{route}_dist_rank{rank}.npy"), dist)
            np.save(os.path.join(job, f"knn_{route}_idx_rank{rank}.npy"), idx)
            out["knn"][route] = {
                "seconds": seconds, "queries": int(Q.shape[0]), "items": int(items.shape[0]),
                "launches": read_launches(wrappers), "exchange_bytes_by_section": exchange.byte_totals()[1],
                "control_plane": port.profiling.counters("cp."),
                "routes": port.profiling.counters("knn.exchange_route.dist_"),
                "flagged_rows": search.flagged_rows, "rerun_rows": search.rerun_rows,
            }
        plane.close()
    maker.shutdown()
    save()
    return 0


def start_ranks(job, spec, faults=""):
    """Write the job's spec and start its RANKS worker processes (fresh
    interpreters: nothing forks a process with CUDA up), each logging to
    DIR/rank<r>.log."""
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k != "SRML_FAULTS"}
    if faults:
        env["SRML_FAULTS"] = faults
    procs = []
    for r in range(RANKS):
        log = open(os.path.join(job, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--nranks", str(RANKS), "--job", job],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    return procs


def wait_ranks(job, procs, timeout):
    """Wait for the job's processes (killing any still running at the
    timeout); their return codes, every process ended."""
    deadline = time.perf_counter() + timeout
    for p, log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
    return [p.returncode for p, _ in procs]


def ranks_log_tail(job):
    tails = []
    for r in range(RANKS):
        with open(os.path.join(job, f"rank{r}.log")) as f:
            tails.append(f"--- rank {r}:\n" + f.read()[-4000:])
    return "\n".join(tails)


def first_difference(attrs, model):
    """The first attribute where a rank-fitted model's attributes differ from
    `model`'s, bit for bit, or None."""
    for key, value in attrs.items():
        want = getattr(model, key)
        if isinstance(value, np.ndarray):
            want = np.asarray(want)
            if value.dtype != want.dtype or value.shape != want.shape or not np.array_equal(value, want):
                return key
        elif value != want:
            return key
    return None


def max_rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max(initial=0.0) / max(np.abs(b).max(initial=0.0), 1e-30))


def ranks_fit_models(port, job, ref_models, names):
    """Rank 0's decoded models of `names` and their first differing fields
    against `ref_models` (None where bit for bit)."""
    from spark_rapids_ml_tpu_torch.core import TELEMETRY_ATTR
    from spark_rapids_ml_tpu_torch.parallel.runner import decode_attrs

    models, differ = {}, {}
    for name in names:
        with open(os.path.join(job, f"attrs_{name}.json")) as f:
            (encoded,) = json.load(f)
        attrs = decode_attrs(encoded)
        check(TELEMETRY_ATTR in attrs, f"{name}: no merged telemetry in the attributes")
        attrs.pop(TELEMETRY_ATTR)
        differ[name] = first_difference(attrs, ref_models[name])
        models[name] = ranks_estimator(port, name)._materialize_model(attrs)
    return models, differ


def equal_up_to_tie_order(idx, dist, idx_ref, dist_ref, idx_ext, dist_ext):
    """(rows whose ids differ, rows that differ beyond the order of equal
    distances) of two exact searches whose distances are bit for bit the
    same: inside a run of equal distances the order of the ids is the
    merge's (a single search orders them by (d2, position), the ranks' merge
    by rank), so each run below the k-th distance must hold the reference's
    id set, and the run at the k-th distance, which either search may cut
    differently, distinct ids of items at exactly that distance: members of
    the reference search KNN_TIE_SLACK past k (idx_ext, dist_ext), whose
    row must run past the k-th distance so that it lists them all."""
    differ = np.flatnonzero((idx != idx_ref).any(axis=1))
    bad = 0
    for r in differ:
        kth = dist_ref[r, -1]
        check(dist_ext[r, -1] > kth, f"query {r}: more than {KNN_TIE_SLACK} extra items at the k-th distance")
        inside = dist_ref[r] < kth
        runs = {}
        for d, i in zip(dist_ref[r][inside], idx_ref[r][inside]):
            runs.setdefault(float(d), set()).add(int(i))
        got = {}
        for d, i in zip(dist[r][inside], idx[r][inside]):
            got.setdefault(float(d), set()).add(int(i))
        last = [int(i) for i in idx[r][~inside]]
        at_kth = {int(i) for i in idx_ext[r][dist_ext[r] == kth]}
        bad += runs != got or len(set(last)) != len(last) or not set(last) <= at_kth
    return int(differ.size), bad


def run_fit_ranks_path(torch, port, wrappers, ref, mesh_rec, knn_mesh_rec, smi):
    """Phase path_fit_ranks (module header): 2 worker processes of this
    script over 2 shards of the card each, against path_fit_mesh's models
    and path_knn_mesh's results; a second pair with rank 1 killed."""
    t_phase = time.perf_counter()
    job = ref["job"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    devices = [list(MESH_DEVICES[:RANK_SHARDS])] * RANKS
    kill_job = os.path.join(job, "kill")
    procs = start_ranks(job, {"devices": devices, "fits": list(RANKS_FITS), "knn": True, "labels": job})
    kill_procs = start_ranks(kill_job, {"devices": devices, "fits": ["kill"], "knn": False, "labels": job},
                             RANKS_KILL_FAULT)
    kill_rcs = wait_ranks(kill_job, kill_procs, RANKS_WORKER_TIMEOUT_S)
    rcs = wait_ranks(job, procs, RANKS_WORKER_TIMEOUT_S)
    workers_s = time.perf_counter() - t_phase
    check(rcs == [0] * RANKS, f"path_fit_ranks workers ended {rcs}:\n{ranks_log_tail(job)}")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # the killed rank: rank 1 exits by injection, rank 0 raises a typed error
    check(kill_rcs == [3, 17], f"the killed-rank pair ended {kill_rcs}:\n{ranks_log_tail(kill_job)}")
    with open(os.path.join(kill_job, "rank0.json")) as f:
        kill_err = json.load(f)["error"]
    check(kill_err["type"] in ("RemoteRankError", "ControlPlaneTimeout") and kill_err["seconds"] <= RANKS_KILL_S,
          f"the killed rank surfaced on rank 0 as {kill_err}")

    # every model bit for bit path_fit_mesh's
    models, differ = ranks_fit_models(port, job, ref["models"], RANKS_FITS)
    check(all(d is None for d in differ.values()),
          f"rank-fitted models differ from the 4-shard models, first field by fit: {differ}")
    # the parent's KMeans model (rank 0's attributes): B1 once a partition, path_fit_mesh's labels
    X_t = blobs(ROWS, COLS, K, SEED, part=(0, RANKS_TRANSFORM_ROWS))
    df_t = port.DataFrame.from_numpy(X_t, num_partitions=PARTITIONS)
    reset_launches(wrappers)
    with port.device.use_device(list(MESH_DEVICES)):
        labels = np.concatenate([p["prediction"] for p in models["kmeans"].transform(df_t).partitions])
        transform_launches = read_launches(wrappers)
        want = np.concatenate([p["prediction"] for p in ref["models"]["kmeans"].transform(df_t).partitions])
    check(transform_launches["min_dist_argmin"] == PARTITIONS,
          f"the parent's KMeans transform launched B1 {transform_launches['min_dist_argmin']} times")
    check(np.array_equal(labels, want), "the parent's KMeans model's labels differ from path_fit_mesh's")
    del X_t, df_t

    # distributed kNN: both routes bit for bit path_knn_mesh's first queries
    idx_ref, dist_ref = ref["knn"]
    idx_ext, dist_ext = ref["knn_ties"]
    check(np.array_equal(dist_ext[:, :KNN_K], dist_ref),
          "the reference search past k gave other distances than path_knn_mesh's")
    knn = {}
    for route in ("ring", "gather"):
        idx = np.concatenate([np.load(os.path.join(job, f"knn_{route}_idx_rank{r}.npy")) for r in range(RANKS)])
        dist = np.concatenate([np.load(os.path.join(job, f"knn_{route}_dist_rank{r}.npy")) for r in range(RANKS)])
        check(idx.shape == idx_ref.shape, f"distributed kNN ({route}) gave {idx.shape}")
        dist_rows_off = int((dist != dist_ref).any(axis=1).sum())
        ids_rows_off, ids_rows_bad = equal_up_to_tie_order(idx, dist, idx_ref, dist_ref, idx_ext, dist_ext)
        seconds = max(rk["knn"][route]["seconds"] for rk in ranks)
        knn[route] = {
            "seconds_by_rank": [rk["knn"][route]["seconds"] for rk in ranks],
            "rows_per_s": RANKS_KNN_QUERIES / seconds,
            "distance_rows_differing_from_path_knn_mesh": dist_rows_off,
            "id_rows_differing_from_path_knn_mesh": ids_rows_off,
            "id_rows_differing_beyond_tie_order": ids_rows_bad,
            "dist_max_rel_err": max_rel_diff(dist, dist_ref),
            "flagged_rows_by_rank": [rk["knn"][route]["flagged_rows"] for rk in ranks],
            "launches_by_rank": [{k: v for k, v in rk["knn"][route]["launches"].items() if v} for rk in ranks],
            "exchange_bytes_by_section_rank0": ranks[0]["knn"][route]["exchange_bytes_by_section"],
            "control_plane_rank0": ranks[0]["knn"][route]["control_plane"],
            "routes_rank0": ranks[0]["knn"][route]["routes"],
        }
        check(dist_rows_off == 0 and ids_rows_bad == 0,
              f"distributed kNN ({route}) differs from path_knn_mesh's: {knn[route]}")
        for rk in ranks:
            for name in ("knn_candidates", "knn_fused_merge"):
                check(rk["knn"][route]["launches"][name] > 0, f"rank {rk['rank']}'s {route} search launched no {name}")

    fits = {}
    for name in RANKS_FITS:
        per = [rk["fits"][name] for rk in ranks]
        fits[name] = {
            "fit_s_by_rank": [p["fit_s"] for p in per], "ingest_s_by_rank": [p["ingest_s"] for p in per],
            "rows_made_s_by_rank": [p["gen_s"] for p in per],
            "rows_waited_s_by_rank": [p["gen_wait_s"] for p in per],
            "path_fit_mesh_fit_s": mesh_rec["parts"][name]["fit_s"] if name in mesh_rec["parts"] else None,
            "against": "mesh_card_vs_cpu card_4_shards" if name == "rf_int" else "path_fit_mesh",
            "cross_process_bytes_by_section_rank0": per[0]["dcn_bytes_by_section"],
            "exchange_bytes_by_section_rank0": per[0]["exchange_bytes_by_section"],
            "control_plane_rank0": per[0]["control_plane"],
            "launches_by_rank": [{k: v for k, v in p["launches"].items() if v} for p in per],
        }
    for rk in ranks:
        check(rk["fits"]["rf_int"]["launches"]["bin_features_fm"] == RANK_SHARDS,
              f"rank {rk['rank']}'s forest launched B2 {rk['fits']['rf_int']['launches']['bin_features_fm']} times")
    # each rank's launches over the phase, for the summary line
    launches_ranks = {}
    for rk in ranks:
        total = {}
        for part in list(rk["fits"].values()) + list(rk["knn"].values()):
            for k, v in part["launches"].items():
                total[k] = total.get(k, 0) + v
        launches_ranks[f"rank{rk['rank']}"] = {k: v for k, v in total.items() if v}

    nccl = "not run: one card"
    if torch.cuda.device_count() >= RANKS:
        nccl_job = os.path.join(job, "nccl")
        t0 = time.perf_counter()
        nccl_devices = [[f"cuda:{r}"] * RANK_SHARDS for r in range(RANKS)]
        nccl_procs = start_ranks(nccl_job, {"devices": nccl_devices, "fits": list(RANKS_FITS), "knn": False,
                                            "labels": job})
        nccl_rcs = wait_ranks(nccl_job, nccl_procs, RANKS_WORKER_TIMEOUT_S)
        check(nccl_rcs == [0] * RANKS, f"the NCCL workers ended {nccl_rcs}:\n{ranks_log_tail(nccl_job)}")
        with open(os.path.join(nccl_job, "rank0.json")) as f:
            nccl_rank0 = json.load(f)
        _, nccl_differ = ranks_fit_models(port, nccl_job, ref["models"], RANKS_FITS)
        nccl = {"backend": nccl_rank0["context"]["backend"], "devices": nccl_devices,
                "seconds": time.perf_counter() - t0, "first_differing_field": nccl_differ,
                "fit_s_rank0": {n: nccl_rank0["fits"][n]["fit_s"] for n in RANKS_FITS}}
        check(nccl["backend"] == "nccl", f"one rank a card chose {nccl['backend']}")
    return {
        "phase": "path_fit_ranks", "ranks": RANKS, "shards_per_rank": RANK_SHARDS, "devices": devices,
        "nvidia_smi": smi, "backend": [rk["context"]["backend"] for rk in ranks],
        "bootstrap_s_by_rank": [rk["context"]["bootstrap_s"] for rk in ranks],
        "fits": fits, "kmeans_transform": {"rows": RANKS_TRANSFORM_ROWS, "partitions": PARTITIONS,
                                           "launches": transform_launches},
        "knn": knn, "knn_queries": RANKS_KNN_QUERIES, "k": KNN_K,
        "path_knn_mesh_rows_per_s": knn_mesh_rec.get("kneighbors_rows_per_s"),
        "killed_rank": {"fault": RANKS_KILL_FAULT, "return_codes": kill_rcs, "rank0_error": kill_err,
                        "gate_s": RANKS_KILL_S},
        "nccl_across_cards": nccl, "launches_ranks": launches_ranks,
        "workers_s": workers_s, "seconds": time.perf_counter() - t_phase,
    }


def mcvc_rows():
    """mesh_card_vs_cpu's integer rows: (X, y) of the linear, PCA and
    logistic fits, (Xf, yf) of the forest."""
    rng = np.random.default_rng(MCVC_SEED)
    X = rng.integers(-2, 3, size=(MCVC_ROWS, MCVC_COLS)).astype(np.float32)
    y = np.clip(X[:, 0] + X[:, 1] + X[:, 2] - X[:, 3] + rng.integers(-1, 2, MCVC_ROWS), -8, 8).astype(np.float32)
    Xf = rng.integers(-3, 4, size=(MCVC_FOREST_ROWS, MCVC_FOREST_COLS)).astype(np.float32)
    yf = np.clip(Xf[:, 0] + Xf[:, 1] + 3, 0, 7).astype(np.float32)
    return X, y, Xf, yf


def mesh_card_vs_cpu(torch, port, wrappers, fh, models=None):
    """Phase mesh_card_vs_cpu: every estimator's mesh fit on 4 shards of the
    card, 1 shard of the card and 8 shards of the CPU, on integer rows:
    KMeans centers, PCA moments, linear and fold statistics, the forest's
    five arrays bit for bit; B3's sharding rule (node_histograms_sharded on
    4 card shards) bit for bit node_histograms over all rows; logistic
    within CVC_LOGISTIC_ATOL."""
    from spark_rapids_ml_tpu_torch.ops import glm, linalg, sweep

    t_start = time.perf_counter()
    rng = np.random.default_rng(MCVC_SEED)
    X_km, _ = integer_blob_rows(MCVC_ROWS, MCVC_COLS, MCVC_KMEANS["k"], MCVC_SEED)
    X, y, Xf, yf = mcvc_rows()
    df_km = port.DataFrame.from_numpy(X_km, num_partitions=4)
    df = port.DataFrame.from_numpy(X, y, num_partitions=4)
    df_log = port.DataFrame.from_numpy(X, (y > 0).astype(np.float32), num_partitions=4)
    df_rf = port.DataFrame.from_numpy(Xf, yf, num_partitions=4)
    out = {}
    launches = {}
    for name, devs, workers in MCVC_CONFIGS:
        port.clear_fit_cache()
        reset_launches(wrappers)
        with port.device.use_device(devs):
            km = port.KMeans(**MCVC_KMEANS, num_workers=workers).fit(df_km)
            inputs = port.LinearRegression(num_workers=workers)._build_fit_inputs(df)
            moments = linalg.weighted_moments(inputs.X, inputs.weight)
            stats = glm.linreg_sufficient_stats(inputs.X, inputs.y, inputs.weight)
            fid = sweep.stage_fold_ids(inputs.n_rows, inputs.n_pad, 3, MCVC_SEED, inputs.mesh)
            folds = glm.sweep_linreg_fold_stats(inputs.X, inputs.y, inputs.weight, fid, 3)
            del inputs, fid
            lin = port.LinearRegression(num_workers=workers).fit(df)
            pca = port.PCA(k=3, num_workers=workers).fit(df)
            log = port.LogisticRegression(**MCVC_LOGREG, num_workers=workers).fit(df_log)
            rf = port.RandomForestRegressor(**MCVC_FOREST, num_workers=workers).fit(df_rf)
        launches[name] = read_launches(wrappers)
        if name == "card_4_shards":
            keep_mesh_model(models, "rf_int", rf)
        cpu = lambda t: t.cpu().numpy()  # noqa: E731
        out[name] = {
            "km": (km.cluster_centers_, km.n_iter_, km.inertia_),
            "moments": [cpu(t) for t in moments], "stats": [cpu(t) for t in stats], "folds": [cpu(t) for t in folds],
            "lin": lin.coef_, "pca": pca.components_, "log": (log.coef_, log.intercept_),
            "rf": [getattr(rf, a) for a in ("features_", "thresholds_", "leaf_values_", "node_counts_",
                                           "impurities_")],
        }
    port.clear_fit_cache()
    base = out["card_4_shards"]
    cases = {}
    for name in ("card_1_shard", "cpu_8_shards"):
        other = out[name]
        same = {
            "kmeans_centers": bool(np.array_equal(base["km"][0], other["km"][0]) and base["km"][1] == other["km"][1]),
            "pca_moments": all(np.array_equal(a, b) for a, b in zip(base["moments"], other["moments"])),
            "linear_stats": all(np.array_equal(a, b) for a, b in zip(base["stats"], other["stats"])),
            "fold_stats": all(np.array_equal(a, b) for a, b in zip(base["folds"], other["folds"])),
            "forest_arrays": all(np.array_equal(a, b) for a, b in zip(base["rf"], other["rf"])),
        }
        scale = max(1.0, float(np.abs(other["log"][0]).max()))
        rec = {"bit_for_bit": same,
               "kmeans_inertia_rel_err": abs(base["km"][2] / other["km"][2] - 1.0),
               "linear_coef_max_rel_err": float(np.abs(base["lin"] - other["lin"]).max() / np.abs(other["lin"]).max()),
               "pca_components_max_abs_err": float(np.abs(base["pca"] - other["pca"]).max()),
               "logistic_coef_max_abs_err": float(np.abs(base["log"][0] - other["log"][0]).max()),
               "logistic_scale": scale}
        check(all(same.values()), f"4 card shards against {name}: {rec}")
        check(rec["linear_coef_max_rel_err"] <= CVC_LINEAR_RTOL and rec["pca_components_max_abs_err"] <= CVC_PCA_ATOL
              and rec["logistic_coef_max_abs_err"] <= CVC_LOGISTIC_ATOL * scale, f"4 card shards against {name}: {rec}")
        cases[name] = rec
    check(launches["card_4_shards"]["bin_features_fm"] == MESH_SHARDS and launches["card_1_shard"]["bin_features_fm"] == 1,
          f"B2 launches {launches}")
    check(launches["card_4_shards"]["min_dist_argmin"] == 0, "a KMeans fit launched B1")

    # B3's sharding rule: per-shard B3 and one psum against all rows
    n = MESH_SHARDS * 65536
    T, nodes, S, B = 2, 4, 2, 128
    sub = torch.from_numpy(rng.integers(0, B, (fh.F_BLOCK, n)).astype(np.int8)).cuda()
    node_rel = torch.from_numpy(rng.integers(0, nodes + 2, (T, n)).astype(np.int32)).cuda()
    stats = torch.from_numpy(rng.integers(0, 4, (T * S, n)).astype(np.float32)).cuda()
    shard = lambda a: [a[:, i * (n // MESH_SHARDS) : (i + 1) * (n // MESH_SHARDS)].contiguous()  # noqa: E731
                       for i in range(MESH_SHARDS)]
    reset_launches(wrappers)
    got = fh.node_histograms_sharded(shard(sub), shard(node_rel), shard(stats), T, nodes, S, B, integer_stats=True)
    hist_launches = read_launches(wrappers)
    whole = fh.node_histograms(sub, node_rel, stats, T, nodes, S, B, integer_stats=True)
    plain = fh.node_histograms_plain(sub.cpu(), node_rel.cpu(), stats.cpu(), T, nodes, S, B)
    route = fh._hist_route(T, nodes, S, B, True)
    check(bool((got[0] == whole).all()) and bool((got[0].cpu() == plain).all()),
          "node_histograms_sharded differs from node_histograms over all rows")
    check(hist_launches[f"node_histograms_{route}"] == MESH_SHARDS, f"B3 launches {hist_launches}")
    return {"phase": "mesh_card_vs_cpu", "rows": MCVC_ROWS, "cols": MCVC_COLS, "forest_rows": MCVC_FOREST_ROWS,
            "forest_cols": MCVC_FOREST_COLS, "kmeans": MCVC_KMEANS, "forest": MCVC_FOREST, "logistic": MCVC_LOGREG,
            "against_4_card_shards": cases, "launches": launches,
            "node_histograms_sharded": {"rows": n, "shards": MESH_SHARDS, "route": route,
                                        "launches": hist_launches, "bit_for_bit": True},
            "gates": {"linear_rtol": CVC_LINEAR_RTOL, "pca_atol": CVC_PCA_ATOL, "logistic_atol": CVC_LOGISTIC_ATOL},
            "seconds": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# ANN, the live index and the UMAP layout on a mesh: four shards of the one
# card
# ---------------------------------------------------------------------------

# path_ann_mesh: each ANN arm's fitted model searched on use_device(["cuda:0"]
# * 4) (num_workers 4: the index list-sharded, each shard scoring its own
# probed lists, the shards' k best merged by ann.probe_merge and one more B7)
# on the profiled call's ANN_PROFILE_QUERIES queries, right after the arm,
# bit for bit the arm's one-shard results of those queries; the recall@10
# gates on the first ANN_CHECK_QUERIES; the 4-bit arm also tiered (hot 0.5)
# bit for bit resident.  The flat arm also times one scoring launch of a
# shard in both tile designs (ann/ivfflat.py header): the one-shard tile
# shape (non-owned probes masked, what the port runs) and a tile compacted
# to the shard's own probes, and counts their differing owned values.
# path_live_mesh: path_stream's live-index script (its adds, deletes and
# overflowing add) on a 4-shard holder of the same payload, its searches of
# LIVE_MESH_QUERIES queries before and after and its to_packed() bit for bit
# the one-shard holder's.  path_umap_mesh: path_umap's fit on 4 shards from
# path_umap's graph (precomputed_knn), bit for bit path_umap's embedding.
# ann_mesh_card_vs_cpu: integer rows (quarter-step codebooks), the flat,
# 8-bit and tiered 4-bit searches, a live index through an add / delete /
# repack script and a 20-epoch layout on 4 card shards, 1 card shard and 8
# CPU shards, bit for bit.
ANN_MESH_PHASES = ("path_ann_mesh", "path_live_mesh", "path_umap_mesh", "ann_mesh_card_vs_cpu")
ANN_TILE_REPS = 5
# cut for the time limit: the 4-shard profiled call takes the first 1,024
# queries (its trace is 4 shards' launches), the tiered 4-bit check the
# first partition of the profiled call's queries
ANN_MESH_PROFILE_QUERIES = 1024
AMC_ROWS, AMC_COLS, AMC_BLOBS, AMC_QUERIES, AMC_NLIST, AMC_NPROBE, AMC_K = 16_384, 64, 64, 256, 64, 8, 10
AMC_M, AMC_ADD_ROWS, AMC_DELETES, AMC_SEED = 8, 512, 1000, 11
AMC_UMAP_ROWS, AMC_UMAP_EPOCHS = 4096, 20
AMC_CONFIGS = (("card_4_shards", MESH_DEVICES), ("card_1_shard", ("cuda:0",)), ("cpu_8_shards", ("cpu",) * 8))


def same_bits(a, b):
    """Ids or distances equal bit for bit (float arrays compared as words)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def flat_tile_designs(torch, ivf, index, Q, dev):
    """One scoring launch (the sweep's rows scored at once) of shard 0 of a
    4-shard flat index in both tile designs: the one-shard tile shape with
    the other shards' probes masked (the port's), and a tile compacted to
    the shard's own probes (width the most any row owns).  Times both, and
    counts the owned candidates whose d2 bits differ between them."""
    _, rows = ivf.sweep_geometry(ANN_PROFILE_QUERIES, ANN_NPROBE * index.l_pad, ivf.flat_tile_bytes(index, ANN_NPROBE))
    qb = torch.from_numpy(Q[:rows]).to(dev)
    qn, d2p, probes = ivf.select_probes(qb, index.centroids[0], index.c_norm[0], ANN_NPROBE)
    owned = probes < index.lps  # shard 0's lists
    local = probes.clamp(0, index.lps - 1)
    width = int(owned.sum(dim=1).max())
    order = torch.argsort((~owned).to(torch.int8), dim=1, stable=True)[:, :width]
    compact = local.gather(1, order)
    scores = ivf._flat_block_scorer(qb, qn, d2p, None)
    planes, sl = index.shard_planes(0), slice(0, rows)
    full_d2, compact_d2 = scores(planes, local, sl), scores(planes, compact, sl)
    keep = owned.gather(1, order)
    differ = int((full_d2.gather(1, order[:, :, None].expand(-1, -1, index.l_pad)).view(torch.int32)
                  != compact_d2.view(torch.int32))[keep].sum())
    return {"rows": rows, "probes": ANN_NPROBE, "owned_width": width, "owned_probes": int(owned.sum()),
            "full_ms": median_ms(torch, lambda: scores(planes, local, sl), ANN_TILE_REPS),
            "compact_ms": median_ms(torch, lambda: scores(planes, compact, sl), ANN_TILE_REPS),
            "owned_values_differing": differ}


def ann_mesh_arm(torch, port, ivf, wrappers, phase, model, Q, ref, dev):
    """One ANN arm's model searched on 4 shards of the card (path_ann_mesh's
    header): staging, a timed and a profiled call of the profiled queries,
    the launch and exchange counters of the timed call, its peak memory, and
    the gates."""
    from spark_rapids_ml_tpu_torch.device import use_device

    algorithm, params, gate = ANN_ARMS[phase]
    pq, fast = algorithm == "ivfpq", params.get("n_bits") == 4
    df = port.DataFrame.from_numpy(Q[:ANN_PROFILE_QUERIES], num_partitions=ANN_QUERY_PARTS)
    want_i, want_d = ref["rows"]
    rec = {"queries": ANN_PROFILE_QUERIES, "shards": MESH_SHARDS}
    with use_device(list(MESH_DEVICES)):
        check(model.num_workers == MESH_SHARDS, f"the model's num_workers is {model.num_workers}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["index_bytes_per_item"], rec["stage_s"] = synced(torch, model.index_bytes_per_item)
        staged = model._staged_pq[1] if pq else model._staged_index[1]
        check(staged.mesh.size == MESH_SHARDS, f"staged on {staged.mesh.size} shards")
        rec["shard_lists"] = [int(t.shape[0]) for t in (staged.codes if pq else staged.list_data)]
        reset_launches(wrappers)
        port.profiling.reset_counters("exchange.")
        (idx, dist), seconds = synced(torch, lambda: ann_rows(model, df))
        rec["launches"] = launches = read_launches(wrappers)
        rec["exchange"] = port.profiling.counters("exchange.ann.")
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        rec["kneighbors_s"], rec["kneighbors_rows_per_s"] = seconds, ANN_PROFILE_QUERIES / seconds
        profile_df = port.DataFrame.from_numpy(Q[:ANN_MESH_PROFILE_QUERIES])
        t0 = time.perf_counter()
        rec["profile"] = profile_run(torch, lambda: ann_rows(model, profile_df), ANN_PROFILE_RANGES, wrappers)
        rec["profile"].update(queries=ANN_MESH_PROFILE_QUERIES, wall_s=time.perf_counter() - t0)
        if fast:
            # the resident call's first partition, in one partition
            half = ANN_PROFILE_QUERIES // ANN_QUERY_PARTS
            model.setAlgoParams(dict(params, hot_fraction=ANN_HOT_FRACTION))
            (i_t, d_t), rec["tiered_s"] = synced(torch, lambda: ann_rows(model, port.DataFrame.from_numpy(Q[:half])))
            rec["tier"] = model._staged_pq[1].tier.stats()
            rec["tiered_queries"] = half
            model.setAlgoParams(params)
            check(same_bits(i_t, idx[:half]) and same_bits(d_t, dist[:half]),
                  "the tiered 4-shard search differs from the resident one")
            check(rec["tier"]["shards"] == MESH_SHARDS and rec["tier"]["misses"] > 0, f"tier {rec['tier']}")
        if not pq:
            rec["tile_designs"] = flat_tile_designs(torch, ivf, model._staged_index[1], Q, dev)
    check(launches["knn_fused_merge"] > 0, f"{phase} on 4 shards launched knn_fused_merge no time")
    for name, used in (("lut_accumulate_probed", pq and not fast), ("fastscan_lut_accumulate_probed", pq and fast)):
        check((launches[name] > 0) == used, f"{phase} on 4 shards launched {name} {launches[name]} times")
    calls = rec["exchange"].get("exchange.ann.probe_merge.calls", 0)
    check(calls > 0 and calls % 2 == 0, f"ann.probe_merge ran {calls} times")
    check(same_bits(idx, want_i) and same_bits(dist, want_d), f"{phase}: 4 shards differ from one shard")
    rec["bit_for_bit_one_shard"] = True
    rec["recall_at_10"] = ivf.recall_at_k(idx[:ANN_CHECK_QUERIES, :10], ref["exact_ids"][:, :10])
    check(rec["recall_at_10"] >= gate, f"{phase} on 4 shards: recall@10 {rec['recall_at_10']} < {gate}")
    rec["one_shard"] = {"kneighbors_rows_per_s": ref["kneighbors_rows_per_s"], "queries": ANN_QUERIES,
                        "profile": ref["profile"], "max_memory_allocated_bytes": ref["max_memory_allocated_bytes"]}
    return rec


def run_ann_mesh_path(parts, seconds):
    launches = {name: sum(p["launches"][name] for p in parts.values())
                for name in ("knn_fused_merge", "lut_accumulate_probed", "fastscan_lut_accumulate_probed")}
    return {"phase": "path_ann_mesh", "shards": MESH_SHARDS, "devices": list(MESH_DEVICES),
            "queries": ANN_PROFILE_QUERIES, "rows_cut": True, "seconds": sum(seconds.values()),
            "part_seconds": seconds, "launches": launches, "parts": parts}


def live_mesh_part(torch, port, wrappers, ref, Q):
    """Phase path_live_mesh (its header above): path_stream's live-index
    script on a 4-shard holder, gated against the one-shard holder's."""
    from spark_rapids_ml_tpu_torch.ann.mutable import MutableIVFIndex
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

    t_start = time.perf_counter()
    Qm = Q[:LIVE_MESH_QUERIES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    holder, stage_s = synced(torch, lambda: MutableIVFIndex(ref["packed"], Mesh(MESH_DEVICES)))
    check(holder.index.mesh.size == MESH_SHARDS, "the holder is not on 4 shards")
    reset_launches(wrappers)
    port.profiling.reset_counters("ann.mutate.")
    port.profiling.reset_counters("exchange.")
    (d0, i0), before_s = synced(torch, lambda: holder.search(Qm, ANN_K, ANN_NPROBE))
    add_s = []
    for j in range(LIVE_ADDS):
        rows = slice(j * LIVE_ADD_ROWS, (j + 1) * LIVE_ADD_ROWS)
        _, s = synced(torch, lambda: holder.add_items(ref["adds"][rows], ANN_ITEMS + np.arange(rows.start, rows.stop)))
        add_s.append(s)
    n_del, delete_s = synced(torch, lambda: holder.delete_items(ref["deleted"]))
    _, repack_add_s = synced(torch, lambda: holder.add_items(ref["burst"], ref["burst_ids"]))
    stats = holder.stats()
    (d1, i1), after_s = synced(torch, lambda: holder.search(Qm, ANN_K, ANN_NPROBE))
    launches = read_launches(wrappers)
    rec = {"phase": "path_live_mesh", "shards": MESH_SHARDS, "queries": LIVE_MESH_QUERIES, "stage_s": stage_s,
           "add_s": add_s, "add_rows_per_s": LIVE_ADDS * LIVE_ADD_ROWS / sum(add_s), "delete_s": delete_s,
           "repack_add_s": repack_add_s, "burst_rows": int(len(ref["burst_ids"])), "stats_after": stats,
           "kneighbors_rows_per_s_before": LIVE_MESH_QUERIES / before_s,
           "kneighbors_rows_per_s_after": LIVE_MESH_QUERIES / after_s, "launches": launches,
           "counters": port.profiling.counters("ann.mutate."), "exchange": port.profiling.counters("exchange.ann."),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "one_shard": {k: ref["one_shard"][k] for k in ("add_rows_per_s", "delete_s", "repack_add_s", "stage_s")}}
    check(n_del == LIVE_DELETES, f"{n_del} of {LIVE_DELETES} deletes on 4 shards")
    check(stats["repacks"] == 1 and stats["tombstoned"] == 0, f"the overflowing add did not repack: {stats}")
    check(launches["min_dist_argmin"] == LIVE_ADDS + 1, f"the 4-shard adds launched min_dist_argmin {launches}")
    check(launches["knn_fused_merge"] > 0, "the 4-shard searches launched knn_fused_merge no time")
    for name, got, want in (("before", (d0, i0), ref["before"]), ("after", (d1, i1), ref["after"])):
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
              f"the 4-shard holder's search {name} the script differs from the one-shard holder's")
    check(not np.isin(i1, ref["deleted"]).any(), "a deleted id came back from the 4-shard holder")
    got, want = holder.to_packed(), ref["packed_after"]
    check(all(same_bits(getattr(got, f), getattr(want, f)) for f in ("items", "ids", "counts", "centroids"))
          and got.n_items == want.n_items, "the 4-shard holder's to_packed() differs from the one-shard holder's")
    rec["bit_for_bit_one_shard"] = True
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def umap_mesh_part(torch, port, wrappers, df, ids, dists, emb, one_phases):
    """Phase path_umap_mesh (its header above): path_umap's fit on 4 shards
    from its graph, bit for bit its embedding."""
    from spark_rapids_ml_tpu_torch.device import use_device

    est = port.UMAP(**UMAP_PARAMS, precomputed_knn=(ids, dists))
    port.clear_fit_cache()
    port.profiling.reset_phase_times()
    port.profiling.reset_counters("exchange.")
    port.profiling.reset_counters("umap.")
    reset_launches(wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with use_device(list(MESH_DEVICES)):
        check(est.num_workers == MESH_SHARDS, f"the estimator's num_workers is {est.num_workers}")
        model, fit_s = synced(torch, lambda: est.fit(df))
    phases = port.profiling.phase_times()
    exchange = port.profiling.counters("exchange.umap.")
    n_pad = -(-UMAP_ROWS // 64) * 64
    check(exchange.get("exchange.umap.layout_rows.calls") == UMAP_PARAMS["n_epochs"],
          f"umap.layout_rows ran {exchange.get('exchange.umap.layout_rows.calls')} times")
    check(exchange.get("exchange.umap.layout_rows.bytes") == UMAP_PARAMS["n_epochs"] * (n_pad // MESH_SHARDS) * 2 * 4,
          f"umap.layout_rows moved {exchange.get('exchange.umap.layout_rows.bytes')} bytes")
    check(same_bits(model.embedding_, emb), "the 4-shard UMAP fit differs from path_umap's embedding")
    port.clear_fit_cache()
    return {"phase": "path_umap_mesh", "shards": MESH_SHARDS, "rows": UMAP_ROWS, "params": UMAP_PARAMS,
            "fit_s": fit_s, "phases": phases, "layout_s": phases.get("umap.layout"),
            "layout_s_one_shard": one_phases.get("umap.layout"),
            "layout_epoch_ms": 1e3 * phases.get("umap.layout", 0.0) / UMAP_PARAMS["n_epochs"],
            "exchange": exchange, "launches": read_launches(wrappers),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "bit_for_bit_one_shard": True}


def ann_mesh_card_vs_cpu(torch, port, ivf, pq_mod, knn_ops, wrappers, dev):
    """Phase ann_mesh_card_vs_cpu (its header above)."""
    from spark_rapids_ml_tpu_torch.ann.mutable import MutableIVFIndex
    from spark_rapids_ml_tpu_torch.ops import umap as umap_ops
    from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, padded_row_count

    t_start = time.perf_counter()
    X, _ = integer_blob_rows(AMC_ROWS, AMC_COLS, AMC_BLOBS, AMC_SEED)
    Q = X[:AMC_QUERIES]
    ids = np.arange(AMC_ROWS, dtype=np.int64)
    rng = np.random.default_rng(AMC_SEED)
    adds = X[rng.integers(0, AMC_ROWS, AMC_ADD_ROWS)] + rng.integers(-1, 2, (AMC_ADD_ROWS, AMC_COLS)).astype(np.float32)
    deleted = rng.choice(AMC_ROWS, AMC_DELETES, replace=False)
    # the payloads, trained on the card, their centroids on the integer grid
    # and the codebooks on the quarter grid: every distance exact
    flat = ivf.build_ivfflat_packed(X, ids, AMC_NLIST, seed=0, device=dev)
    flat.centroids = np.round(flat.centroids).astype(np.float32)
    pqs = {}
    for bits in (8, 4):
        p = pq_mod.build_ivfpq_packed(X, ids, AMC_NLIST, m_sub=AMC_M, n_bits=bits, seed=0, device=dev)
        p.centroids = np.round(p.centroids).astype(np.float32)
        p.codebooks = (np.round(p.codebooks * 4) / 4).astype(np.float32)
        pqs[bits] = p
    # one layout from one graph, assembled on the card
    Xu = torch.from_numpy(X[:AMC_UMAP_ROWS]).to(dev)
    k_d, k_i = knn_ops.knn_search_prepared(knn_ops.prepare_items(Xu, np.arange(AMC_UMAP_ROWS), dev), Xu, UMAP_K)
    i_t = torch.from_numpy(k_i).to(dev)
    W = umap_ops._calibrated_weights(i_t, torch.from_numpy(k_d).to(dev), 1.0, 1.0)
    n_pad = padded_row_count(AMC_UMAP_ROWS)
    tails, w = (t.cpu() for t in umap_ops.build_head_layout_device(i_t, W, n_pad, AMC_UMAP_EPOCHS))
    init = umap_ops._random_init(1, n_pad, 2, dev).cpu()
    a, b = umap_ops.find_ab_params(1.0, 0.1)
    out, seconds, launches = {}, {}, {}
    for name, devs in AMC_CONFIGS:
        mesh = Mesh(devs)
        reset_launches(wrappers)
        t0 = time.perf_counter()
        r = {"flat": ivf.ivfflat_search_prepared(ivf.index_from_packed(flat, mesh), Q, AMC_K, AMC_NPROBE),
             "pq8": pq_mod.ivfpq_search_prepared(pq_mod.index_from_packed_pq(pqs[8], mesh), Q, AMC_K, AMC_NPROBE,
                                                 refine_items=pqs[8].items, refine_ratio=4),
             "pq4_tiered": pq_mod.ivfpq_search_prepared(
                 pq_mod.tiered_index_from_packed_pq(pqs[4], ANN_HOT_FRACTION, mesh), Q, AMC_K, AMC_NPROBE,
                 refine_items=pqs[4].items, refine_ratio=8)}
        holder = MutableIVFIndex(flat, mesh)
        holder.add_items(adds, AMC_ROWS + np.arange(AMC_ADD_ROWS))
        holder.delete_items(deleted)
        holder.repack()
        r["live_search"] = holder.search(Q, AMC_K, AMC_NPROBE)
        packed = holder.to_packed()
        r["live_packed"] = (packed.items, packed.ids, packed.counts)
        r["layout"] = umap_ops.optimize_layout_sharded(
            init.to(devs[0]), tails.to(devs[0]), w.to(devs[0]), AMC_UMAP_ROWS, mesh, a, b, AMC_UMAP_EPOCHS, 1.0, 1.0,
            5, 1).cpu().numpy()
        if name != "cpu_8_shards":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches[name] = read_launches(wrappers)
        out[name] = r
    base = out["card_1_shard"]
    equal = {}
    for name in ("card_4_shards", "cpu_8_shards"):
        for key, want in base.items():
            got = out[name][key]
            if isinstance(want, tuple):
                same = len(got) == len(want) and all(same_bits(g, v) for g, v in zip(got, want))
            else:
                same = same_bits(got, want)
            equal[f"{name}.{key}"] = same
    check(all(equal.values()), f"4 card shards, 1 card shard and 8 CPU shards differ: {equal}")
    for name in ("card_4_shards", "card_1_shard"):
        used = launches[name]
        check(used["knn_fused_merge"] > 0 and used["lut_accumulate_probed"] > 0
              and used["fastscan_lut_accumulate_probed"] > 0 and used["min_dist_argmin"] > 0,
              f"{name} launched a kernel of the path no time: {used}")
    check(sum(launches["cpu_8_shards"].values()) == 0, "the CPU shards counted a launch")
    return {"phase": "ann_mesh_card_vs_cpu", "rows": AMC_ROWS, "cols": AMC_COLS, "queries": AMC_QUERIES,
            "nlist": AMC_NLIST, "nprobe": AMC_NPROBE, "k": AMC_K, "umap_rows": AMC_UMAP_ROWS,
            "umap_epochs": AMC_UMAP_EPOCHS, "equal": equal, "seconds_by_config": seconds, "launches": launches,
            "seconds": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# path_spark: the Spark executor routes through a stand-in of pyspark
# ---------------------------------------------------------------------------

# The card host has no pyspark: for the phase's duration a stand-in of the
# surface the port's adapter touches is installed in sys.modules.  Its frames
# hold port Partition batches (no pandas), a task's partition being a list of
# batches; repartition(n) deals whole partitions out round-robin (no row is
# copied); a barrier stage runs its tasks as threads whose allGather is a
# real rendezvous.  The rows are path's and path_knn's own arrays: each
# features column is a row slice of them, read in place.
SPARK_PARTS = 2            # path's partitions 0-1: 2 x 125,000 rows
SPARK_KNN_TASKS = 2        # barrier tasks of the kNN part, one slice of the card each
SPARK_SEED = 21            # the OLS label's weights and noise
SPARK_TASK_TIMEOUT_S = 600
SPARK_NUM_WORKERS_CONF = "spark.rapids.ml.tpu.numWorkers"


class StandInTaskContext:
    """pyspark.BarrierTaskContext: partitionId and an allGather that is a real
    rendezvous of the stage's task threads."""

    _tls = threading.local()

    def __init__(self, rank, stage):
        self._rank, self._stage = rank, stage

    @classmethod
    def get(cls):
        return cls._tls.ctx

    def partitionId(self):
        return self._rank

    def allGather(self, message=""):
        st = self._stage
        with st["lock"]:
            st["slots"][self._rank] = message
        st["barrier"].wait()
        out = list(st["slots"])
        st["barrier"].wait()  # every task has read the round before the next writes
        return out

    def barrier(self):
        self.allGather("")


class StandInLit:
    def __init__(self, value):
        self.value = value


class StandInField:
    def __init__(self, name, ddl):
        self.name = name
        self.dataType = types.SimpleNamespace(simpleString=lambda d=ddl: d)


def ddl_fields(schema):
    """(name, type) of each top-level field of a DDL string."""
    fields, depth, cur = [], 0, ""
    for ch in schema:
        depth += (ch == "<") - (ch == ">")
        if ch == "," and depth == 0:
            fields.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        fields.append(cur.strip())
    return [(f.partition(" ")[0].strip("`"), f.partition(" ")[2].strip()) for f in fields]


def run_barrier_tasks(task_batches, udf):
    """One barrier stage: udf(iter(batches)) of each task on its own thread;
    the output batches of each task."""
    n = len(task_batches)
    stage = {"lock": threading.Lock(), "slots": [None] * n,
             "barrier": threading.Barrier(n, timeout=SPARK_TASK_TIMEOUT_S)}
    results, errors = [None] * n, []

    def work(rank):
        StandInTaskContext._tls.ctx = StandInTaskContext(rank, stage)
        try:
            results[rank] = list(udf(iter(task_batches[rank])))
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            stage["barrier"].abort()
        finally:
            StandInTaskContext._tls.ctx = None

    threads = [threading.Thread(target=work, args=(r,), name=f"spark-task-{r}") for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    StandInSpark.stages.append(n)
    return results


def batch_rows(batches):
    return [{c: b[c][r] for c in b.columns} for b in batches for r in range(len(b))]


class StandInRdd:
    def __init__(self, frame):
        self._frame, self._barrier = frame, False

    def barrier(self):
        self._barrier = True
        return self

    def mapPartitions(self, fn):
        return self

    def withResources(self, profile):
        return self

    def run(self):
        f = self._frame
        if self._barrier:
            return run_barrier_tasks(f._parts, f._udf)
        return f._materialize()

    def collect(self):
        return batch_rows([b for out in self.run() for b in out])

    def getNumPartitions(self):
        return len(self._frame._parts)


class StandInFrame:
    """pyspark.sql.DataFrame: partitions of port Partition batches, a schema,
    and a lazy mapInPandas stage.  No toPandas: nothing is collected."""

    def __init__(self, parts, fields, spark, udf=None):
        self._parts, self._fields, self.sparkSession, self._udf = parts, list(fields), spark, udf

    @property
    def columns(self):
        return [n for n, _ in self._fields]

    @property
    def schema(self):
        return types.SimpleNamespace(fields=[StandInField(n, t) for n, t in self._fields])

    @property
    def rdd(self):
        return StandInRdd(self)

    def _materialize(self):
        """The output batches of each partition (the stage run task by task,
        not a barrier)."""
        if self._udf is None:
            return [list(p) for p in self._parts]
        return [list(self._udf(iter(p))) for p in self._parts]

    def _settled(self):
        return self if self._udf is None else StandInFrame(self._materialize(), self._fields, self.sparkSession)

    def repartition(self, n):
        f = self._settled()
        return StandInFrame([[b for p in f._parts[i::n] for b in p] for i in range(n)], f._fields,
                            self.sparkSession)

    def select(self, *cols):
        f = self._settled()
        types_of = dict(f._fields)
        parts = [[type(b)({c: b[c] for c in cols}) for b in p] for p in f._parts]
        return StandInFrame(parts, [(c, types_of[c]) for c in cols], self.sparkSession)

    def withColumn(self, name, expr):
        if not isinstance(expr, StandInLit):
            raise TypeError(f"the stand-in takes lit() columns only, got {expr!r}")
        f = self._settled()
        parts = [[b.with_columns({name: np.full(len(b), expr.value, np.int32)}) for b in p] for p in f._parts]
        return StandInFrame(parts, f._fields + [(name, "int")], self.sparkSession)

    def union(self, other):
        check(self.columns == other.columns, "union of frames with other columns")
        return StandInFrame(self._settled()._parts + other._settled()._parts, self._fields, self.sparkSession)

    def mapInPandas(self, udf, schema=None):
        if self._udf is not None:
            prev = self._udf
            udf = functools.partial(lambda u, it: u(b for x in it for b in prev(iter([x]))), udf)
        return StandInFrame(self._parts, ddl_fields(schema), self.sparkSession, udf)

    def collect(self):
        return batch_rows([b for p in self._materialize() for b in p])

    def sort(self, col):
        batches = [b for p in self._materialize() for b in p]
        cols = {c: np.concatenate([b[c] for b in batches]) for c in batches[0].columns}
        order = np.argsort(cols[col], kind="stable")
        return StandInFrame([[type(batches[0])({c: v[order] for c, v in cols.items()})]], self._fields,
                            self.sparkSession)

    def cache(self):
        return self

    def unpersist(self):
        return self


StandInFrame.__module__ = "pyspark.sql.dataframe"


class StandInSpark:
    """SparkSession: its version, a conf (local master: no stage-level
    scheduling) and createDataFrame of a barrier RDD.  `stages` logs the
    task count of every barrier stage run."""

    stages = []
    version = "3.5.0"

    def __init__(self, conf):
        conf = {"spark.master": "local[2]", **conf}
        self.sparkContext = types.SimpleNamespace(getConf=lambda: types.SimpleNamespace(get=conf.get))

    def frame(self, parts, fields):
        return StandInFrame(parts, fields, self)

    def createDataFrame(self, rdd, schema):
        return StandInFrame(rdd.run(), ddl_fields(schema), self)


class standin_pyspark:
    """The stand-in in sys.modules for the enclosed block, then the modules
    that were there before."""

    NAMES = ("pyspark", "pyspark.sql", "pyspark.sql.functions")

    def __enter__(self):
        self.saved = {n: sys.modules.get(n) for n in self.NAMES}
        mod, sql, fns = (types.ModuleType(n) for n in self.NAMES)
        mod.BarrierTaskContext = StandInTaskContext
        fns.lit, fns.col = StandInLit, (lambda c: c)
        mod.sql, sql.functions = sql, fns
        sys.modules.update(zip(self.NAMES, (mod, sql, fns)))
        StandInSpark.stages.clear()
        return self

    def __exit__(self, *exc):
        for n, m in self.saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        return False


def spark_blocks(X):
    per = ROWS // PARTITIONS
    return [X[i * per:(i + 1) * per] for i in range(SPARK_PARTS)]


def spark_fit_parts(torch, port, wrappers, X):
    """path_spark's parts 1-3 on path's partitions 0-1 (X is path's rows):
    KMeans with path's parameters fitted through the barrier stage and
    transformed on the executors, then OLS on the same rows (y = X w +
    noise) fitted through the barrier stage and scored by
    _transformEvaluate(RegressionEvaluator rmse) on the executors.  Each
    result bit for bit the port's local route on a port DataFrame of the
    same partitions."""
    Partition = port.dataframe.Partition
    blocks = spark_blocks(X)
    rows = sum(len(b) for b in blocks)
    local_df = port.DataFrame([{"features": b} for b in blocks])
    spark = StandInSpark({})
    sdf = spark.frame([[Partition({"features": b})] for b in blocks], [("features", "array<float>")])
    parts = {}

    def kmeans():
        return port.KMeans(k=K, maxIter=MAX_ITER, initMode="random", seed=SEED)

    port.clear_fit_cache()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = kmeans().fit(sdf)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = read_launches(wrappers)
    stages = list(StandInSpark.stages)
    t0 = time.perf_counter()
    local = kmeans().fit(local_df)
    local_fit_s = time.perf_counter() - t0
    port.clear_fit_cache()
    differ = first_difference({n: getattr(model, n) for n in ("cluster_centers_", "inertia_", "n_iter_")}, local)
    telemetry = model._fit_telemetry
    check(stages == [1], f"the KMeans fit ran barrier stages of {stages} tasks")
    check(differ is None, f"the barrier KMeans fit differs from the local fit first in {differ}")
    check(telemetry is not None and telemetry.phases["runner.fit"]["count"] == 1,
          "the barrier KMeans model lost the runner's telemetry")
    parts["kmeans_fit"] = {
        "rows": rows, "cols": COLS, "k": K, "max_iter": MAX_ITER, "barrier_tasks": stages[0],
        "seconds": fit_s, "rows_per_s": rows / fit_s, "local_fit_s": local_fit_s, "n_iter": model.n_iter_,
        "inertia": model.inertia_, "first_differing_field": differ, "launches": launches_fit,
        "runner_fit_s": telemetry.phases["runner.fit"]["total_s"],
        "runner_build_inputs_s": telemetry.phases.get("runner.build_inputs", {}).get("total_s"),
    }

    reset_launches(wrappers)
    t0 = time.perf_counter()
    batches = [b for p in model.transform(sdf)._materialize() for b in p]
    transform_s = time.perf_counter() - t0
    launches_transform = read_launches(wrappers)
    pred = np.concatenate([b["prediction"] for b in batches])
    t0 = time.perf_counter()
    want = np.concatenate([p["prediction"] for p in local.transform(local_df).partitions])
    local_transform_s = time.perf_counter() - t0
    check(launches_transform["min_dist_argmin"] == SPARK_PARTS,
          f"the executor transform launched B1 {launches_transform['min_dist_argmin']} times")
    check(pred.dtype == np.int32 and pred.shape == (rows,), f"executor predictions {pred.dtype} {pred.shape}")
    check(np.array_equal(pred, want), "the executor transform's predictions differ from the local transform's")
    check(all(np.shares_memory(b["features"], blk) for b, blk in zip(batches, blocks)),
          "the executor transform copied the features column")
    parts["kmeans_transform"] = {
        "rows": rows, "batches": len(batches), "b1_shape": [rows // SPARK_PARTS, COLS, K],
        "seconds": transform_s, "rows_per_s": rows / transform_s, "local_transform_s": local_transform_s,
        "prediction_dtype": str(pred.dtype), "launches": launches_transform,
    }
    del model, local, pred, want, batches

    rng = np.random.default_rng(SPARK_SEED)
    w = rng.standard_normal(COLS).astype(np.float32)
    labels = [(b @ w + rng.standard_normal(len(b)).astype(np.float32)).astype(np.float32) for b in blocks]
    local_df = port.DataFrame([{"features": b, "label": y} for b, y in zip(blocks, labels)])
    sdf = spark.frame([[Partition({"features": b, "label": y})] for b, y in zip(blocks, labels)],
                      [("features", "array<float>"), ("label", "float")])
    StandInSpark.stages.clear()
    port.clear_fit_cache()
    reset_launches(wrappers)
    t0 = time.perf_counter()
    model = port.LinearRegression().fit(sdf)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    stages = list(StandInSpark.stages)
    t0 = time.perf_counter()
    local = port.LinearRegression().fit(local_df)
    local_fit_s = time.perf_counter() - t0
    port.clear_fit_cache()
    differ = first_difference({"coef_": model.coef_, "intercept_": model.intercept_}, local)
    evaluator = port.RegressionEvaluator(metricName="rmse")
    t0 = time.perf_counter()
    rmse = model._transformEvaluate(sdf, evaluator)
    evaluate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rmse_local = local._transformEvaluate(local_df, evaluator)
    local_evaluate_s = time.perf_counter() - t0
    check(stages == [1], f"the OLS fit ran barrier stages of {stages} tasks")
    check(differ is None, f"the barrier OLS fit differs from the local fit first in {differ}")
    check(rmse == rmse_local and math.isfinite(rmse[0]),
          f"executor rmse {rmse} against the local _transformEvaluate's {rmse_local}")
    parts["linreg"] = {
        "rows": rows, "cols": COLS, "barrier_tasks": stages[0], "fit_s": fit_s, "fit_rows_per_s": rows / fit_s,
        "local_fit_s": local_fit_s, "first_differing_field": differ, "rmse": rmse[0],
        "transform_evaluate_s": evaluate_s, "transform_evaluate_rows_per_s": rows / evaluate_s,
        "local_transform_evaluate_s": local_evaluate_s, "seconds": fit_s + evaluate_s,
    }
    port.clear_fit_cache()
    return parts


class task_launches:
    """Each barrier task's B5 and B7 launches: the search's per-block step
    (ops/knn._kernel_block, where the kNN search launches both) is wrapped
    for the enclosed block, each call under one lock, so the step of the
    wrappers' own counters during a call is the calling task's (the
    counters and the wrappers are untouched)."""

    NAMES = ("knn_candidates", "knn_fused_merge")

    def __init__(self, knn_ops, kk):
        self.knn_ops, self.kk, self.lock, self.by_task = knn_ops, kk, threading.Lock(), {}

    def __enter__(self):
        self.saved = self.knn_ops._kernel_block
        step, kk = self.saved, self.kk

        def call(*args, **kwargs):
            with self.lock:
                before = {n: getattr(kk, n).launches for n in self.NAMES}
                out = step(*args, **kwargs)
                task = self.by_task.setdefault(threading.current_thread().name, dict.fromkeys(self.NAMES, 0))
                for n in self.NAMES:
                    task[n] += getattr(kk, n).launches - before[n]
            return out

        self.knn_ops._kernel_block = call
        return self

    def __exit__(self, *exc):
        self.knn_ops._kernel_block = self.saved
        return False


def spark_knn_part(torch, port, knn_ops, kk, wrappers, X, Q, ref):
    """path_spark's kNN part: NearestNeighbors(k=200) fitted on a stand-in
    frame of path_knn's items, kneighbors of its first RANKS_KNN_QUERIES
    queries in one barrier stage of SPARK_KNN_TASKS tasks (each task on its
    own one-shard slice of the card, distributed_kneighbors' thread ranks),
    held against path_knn_mesh's kept results up to tie order.  The host
    merges of candidate lists (knn_ops.topk_merge) are counted and timed."""
    Partition = port.dataframe.Partition
    n_q = RANKS_KNN_QUERIES
    ids = np.arange(len(X), dtype=np.int64)
    spark = StandInSpark({SPARK_NUM_WORKERS_CONF: str(SPARK_KNN_TASKS)})
    fields = [("features", "array<float>"), ("row", "bigint")]
    item_sdf = spark.frame([[Partition({"features": X[s], "row": ids[s]})]
                            for s in np.array_split(np.arange(len(X)), SPARK_KNN_TASKS)], fields)
    q_ids = np.arange(n_q, dtype=np.int64)
    query_sdf = spark.frame([[Partition({"features": Q[s], "row": q_ids[s]})]
                             for s in np.array_split(np.arange(n_q), SPARK_KNN_TASKS)], fields)
    # the tasks' merge seconds are summed over both task threads
    merges = {"calls": 0, "seconds": 0.0, "shapes": set()}
    merge, merges_lock = knn_ops.topk_merge, threading.Lock()

    def counting_merge(*args):
        t = time.perf_counter()
        out = merge(*args)
        with merges_lock:
            merges["seconds"] += time.perf_counter() - t
            merges["calls"] += 1
            merges["shapes"].add(tuple(args[0].shape))
        return out

    model = port.NearestNeighbors(k=KNN_K).setIdCol("row").fit(item_sdf)
    knn_ops.topk_merge = counting_merge
    try:
        with task_launches(knn_ops, kk) as tally:
            torch.cuda.synchronize()
            reset_launches(wrappers)
            t0 = time.perf_counter()
            _, _, knn_df = model.kneighbors(query_sdf)
            batches = [b for p in knn_df._materialize() for b in p]
            seconds = time.perf_counter() - t0
            launches = read_launches(wrappers)
    finally:
        knn_ops.topk_merge = merge
    stages = list(StandInSpark.stages)
    q = np.concatenate([b["query_row"] for b in batches])
    idx = np.concatenate([b["indices"] for b in batches])
    dist = np.concatenate([b["distances"] for b in batches])
    idx_ref, dist_ref = ref["knn"]
    idx_ext, dist_ext = ref["knn_ties"]
    check(stages == [SPARK_KNN_TASKS], f"kneighbors ran barrier stages of {stages} tasks")
    check(np.array_equal(q, q_ids), "the knn frame is not sorted by query id")
    check(idx.shape == idx_ref.shape and dist.dtype == np.float32, f"barrier kneighbors gave {idx.shape}")
    dist_rows_off = int((dist != dist_ref).any(axis=1).sum())
    ids_rows_off, ids_rows_bad = equal_up_to_tie_order(idx, dist, idx_ref, dist_ref, idx_ext, dist_ext)
    per_task = {t: tally.by_task.get(f"spark-task-{t}", dict.fromkeys(task_launches.NAMES, 0))
                for t in range(SPARK_KNN_TASKS)}
    check(dist_rows_off == 0 and ids_rows_bad == 0,
          f"barrier kNN against path_knn_mesh: {dist_rows_off} distance rows, {ids_rows_bad} id rows beyond tie order")
    for t, got in per_task.items():
        check(got["knn_candidates"] > 0 and got["knn_fused_merge"] > 0, f"barrier task {t} launched {got}")
    for name in task_launches.NAMES:
        check(sum(got[name] for got in per_task.values()) == launches[name],
              f"the tasks' {name} launches do not add up to the counter's {launches[name]}")
    return {
        "items": len(X), "cols": X.shape[1], "queries": n_q, "k": KNN_K, "barrier_tasks": stages[0],
        "seconds": seconds, "rows_per_s": n_q / seconds, "launches": launches, "launches_by_task": per_task,
        "distance_rows_differing_from_path_knn_mesh": dist_rows_off,
        "id_rows_differing_from_path_knn_mesh": ids_rows_off, "id_rows_differing_beyond_tie_order": ids_rows_bad,
        "host_merge": {"calls": merges["calls"], "seconds": merges["seconds"],
                       "shapes": sorted(merges["shapes"])},
    }


def run_spark_path(parts, seconds, walls):
    """path_spark's record: its parts (each already printed), their
    seconds, and the phase's wall seconds (the local baselines and the
    gates included)."""
    return {"phase": "path_spark", "parts": parts, "seconds": seconds, "wall_s": walls,
            "phase_s": sum(walls.values()), "rows_cut": False}


def kernel_wrappers():
    """Every kernel wrapper of the port by name, each counting its launches
    in `.launches`."""
    from spark_rapids_ml_tpu_torch.ops import binning
    from spark_rapids_ml_tpu_torch.ops import exchange_kernels as ek
    from spark_rapids_ml_tpu_torch.ops import forest_hist as fh
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import nearest_center as nc
    from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk

    return {
        "min_dist_argmin": nc.min_dist_argmin,
        "bin_features_fm": binning.bin_features_fm,
        "node_histograms_mma": fh.node_histograms_mma,
        "node_histograms_atomic": fh.node_histograms_atomic,
        "node_histograms_bucketed": fh.node_histograms_bucketed,
        "knn_candidates": kk.knn_candidates,
        "knn_candidates_audit": kk.knn_candidates_audit,
        "knn_fused_merge": kk.knn_fused_merge,
        "knn_count": kk.knn_count,
        "lut_accumulate": pk.lut_accumulate,
        "lut_accumulate_probed": pk.lut_accumulate_probed,
        "fastscan_lut_accumulate": pk.fastscan_lut_accumulate,
        "fastscan_lut_accumulate_probed": pk.fastscan_lut_accumulate_probed,
        "ring_shift": ek.ring_shift,
    }


def main():
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of the phases to run (default: all)")
    # path_fit_ranks' worker processes: chip_smoke.py --rank r --nranks n --job DIR
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--nranks", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--job", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        if not torch.cuda.is_available() or not os.path.isdir(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
            print("chip_smoke.py: a path_fit_ranks worker needs a GPU and a checkout", file=sys.stderr)
            return 2
        sys.path.insert(0, REPO)
        return ranks_worker(torch, args.rank, args.nranks, args.job)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    for later in ("knn_audit", "knn_streamed", "path_knn_mesh", "knn_ring"):
        if later in phases and "path_knn" not in phases:
            parser.error(f"{later} runs on path_knn's items and results: add path_knn")
    if "knn_ring" in phases and "path_knn_mesh" not in phases:
        parser.error("knn_ring runs on path_knn_mesh's sharded items: add path_knn_mesh")
    if "path_serve" in phases and "path" not in phases:
        parser.error("path_serve serves the models of the path phases and routes path's KMeans model: add path")
    lane_needs = ("path_serve", "path", "path_linreg", "path_logreg", "path_pca")
    if "path_serve_lanes" in phases and not set(lane_needs) <= set(phases):
        parser.error(f"path_serve_lanes multiplexes the models of {lane_needs[1:]} beside path_serve: add "
                     f"{sorted(set(lane_needs) - set(phases))}")
    mesh_needs = ("path", "path_pca", "path_linreg", "path_logreg", "path_rf_reg")
    if "path_fit_mesh" in phases and not set(mesh_needs) <= set(phases):
        parser.error(f"path_fit_mesh fits each cell's estimator on 4 shards right after the path that makes its rows "
                     f"and holds it against that path's: add {sorted(set(mesh_needs) - set(phases))}")
    ranks_needs = ("path_fit_mesh", "mesh_card_vs_cpu", "path_knn", "path_knn_mesh")
    if "path_fit_ranks" in phases and not set(ranks_needs) <= set(phases):
        parser.error(f"path_fit_ranks holds its ranks' models and kNN results against path_fit_mesh's, "
                     f"mesh_card_vs_cpu's and path_knn_mesh's: add {sorted(set(ranks_needs) - set(phases))}")
    for later, needs in (("path_live_mesh", "path_stream"), ("path_umap_mesh", "path_umap")):
        if later in phases and needs not in phases:
            parser.error(f"{later} replays {needs}'s script on 4 shards against its results: add {needs}")
    spark_needs = ("path", "path_knn", "path_knn_mesh")
    if "path_spark" in phases and not set(spark_needs) <= set(phases):
        parser.error(f"path_spark runs on path's rows and path_knn's items against path_knn_mesh's results: add "
                     f"{sorted(set(spark_needs) - set(phases))}")
    if "path_ann_mesh" in phases and not set(ANN_ARMS) & set(phases):
        parser.error(f"path_ann_mesh searches the fitted models of the ANN arms on 4 shards: add one of {list(ANN_ARMS)}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "spark_rapids_ml_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import spark_rapids_ml_tpu_torch as port
    import spark_rapids_ml_tpu_torch.ops.forest  # noqa: F401  (port.ops.forest)
    import spark_rapids_ml_tpu_torch.parallel.faults  # noqa: F401  (port.parallel.faults)
    import spark_rapids_ml_tpu_torch.serving  # noqa: F401  (port.serving)
    from spark_rapids_ml_tpu_torch.ops import _build, binning
    from spark_rapids_ml_tpu_torch.ops import exchange_kernels as ek
    from spark_rapids_ml_tpu_torch.ops import forest_hist as fh
    from spark_rapids_ml_tpu_torch.ops import knn as knn_ops
    from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
    from spark_rapids_ml_tpu_torch.ops import nearest_center as nc
    from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk
    from spark_rapids_ml_tpu_torch.ann import ivfflat as ivf
    from spark_rapids_ml_tpu_torch.ann import pq as pq_mod
    from spark_rapids_ml_tpu_torch.parallel import topology

    wrappers = kernel_wrappers()
    t_start = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
    })

    libraries = sorted({os.path.basename(src)[: -len(".cu")] for src in KERNEL_SOURCES.values()})
    seconds = _build.build(libraries)  # one nvcc per source, all started together
    ptxas = {name: [line.strip() for line in _build.build_log(name).splitlines()
                    if "registers" in line or "spill" in line or "smem" in line]
             for name in libraries}
    emit({"phase": "build", "nvcc_s": seconds, "ptxas": ptxas})
    dev = port.device.resolve()  # cuda:0, with TF32 off for the plain versions
    results = {}
    # path_serve serves each path's model right after its path, while the
    # path's rows exist (keep holds the models until then)
    serve = ServePlane(torch, port, nc, kk, knn_ops, wrappers, dev) if "path_serve" in phases else None
    # path_serve_lanes multiplexes the same models right after path_serve
    # has served them
    lanes = LanePlane(torch, port, wrappers, serve) if "path_serve_lanes" in phases else None
    # path_fit_mesh fits each cell on 4 shards right after its path, against
    # the path's model or reference (keep holds them until then)
    mesh_parts, mesh_s = ({}, {}) if "path_fit_mesh" in phases else (None, None)
    # path_fit_ranks holds its ranks' fits against path_fit_mesh's models and
    # its kNN against path_knn_mesh's results, and its workers read the
    # paths' labels from its job directory
    ranks_ref = {"models": {}, "job": ranks_job_dir()} if "path_fit_ranks" in phases else None
    keep = {} if serve is not None or mesh_parts is not None or "path_ann_mesh" in phases else None
    # path_spark runs its parts beside the paths that make their rows (path's
    # KMeans rows, path_knn's items), each part's record printed at once;
    # its kNN part holds path_knn_mesh's kept results
    spark_parts, spark_s, spark_wall = ({}, {}, {}) if "path_spark" in phases else (None, None, None)
    knn_ref = ranks_ref if ranks_ref is not None else ({} if spark_parts is not None else None)

    def spark_part(name, fn, *args):
        t0 = time.perf_counter()
        with standin_pyspark():
            rec = fn(*args)
        seconds_part = time.perf_counter() - t0
        for part, prec in (rec.items() if name == "fits" else [(name, rec)]):
            spark_parts[part] = prec
            spark_s[part] = prec["seconds"]
            emit({"phase": "path_spark", "part": part, "nvidia_smi": smi, **prec})
        spark_wall[name] = seconds_part

    def mesh_part(name, fn, *args):
        t0 = time.perf_counter()
        mesh_parts[name] = fn(*args, models=ranks_ref["models"] if ranks_ref is not None else None)
        mesh_s[name] = time.perf_counter() - t0
        emit({"phase": "path_fit_mesh", "part": name, "seconds": mesh_s[name], **mesh_parts[name]})
        port.clear_fit_cache()

    if "kernels" in phases:
        gen = torch.Generator().manual_seed(SEED)
        rows = [check_kernel_shape(torch, nc, n, d, k, gen, dev) for n, d, k in SHAPES]
        unaligned = [check_kernel_shape(torch, nc, n, d, k, gen, dev, misaligned)
                     for n, d, k, misaligned in SHAPES_UNALIGNED]
        emit({"phase": "kernels", "kernel": "min_dist_argmin", "dtype": "float32",
              "peak_fp32_flops": PEAK_FP32_FLOPS, "peak_bytes_per_s": PEAK_BYTES_PER_S,
              "shapes": rows, "unaligned": unaligned})
        # the float64 instantiation: exact agreement at the JAX package's shapes
        for n, d, k in SHAPES[:4]:
            X = (torch.randn(n, d, generator=gen, dtype=torch.float64) * 4).round().div(4).to(dev)
            C = (torch.randn(k, d, generator=gen, dtype=torch.float64) * 4).round().div(4).to(dev)
            m, a = nc.min_dist_argmin(X, C)
            pm, pa = nc.min_dist_argmin_plain(X, C)
            check(m.dtype == torch.float64 and bool((a == pa).all()) and bool((m == pm).all()),
                  f"float64 ({n},{d},{k}) disagrees with the plain version")
        emit({"phase": "kernels_f64", "shapes": [list(s) for s in SHAPES[:4]], "exact": True})
        results["kernels"] = rows[-1]

    # path_stream's engines run beside the paths that make their rows (the
    # KMeans cell's, the PCA cell's, the GLM cells'), each dataset made once
    stream_parts = {}
    if {"path", "path_stream"} & set(phases):
        t0 = time.perf_counter()
        X_km = blobs(ROWS, COLS, K, SEED)
        gen_s = time.perf_counter() - t0
        if "path" in phases:
            results["path"] = run_path(torch, port, nc, wrappers, X_km, gen_s, keep)
            emit(results["path"])
            port.clear_fit_cache()
            km_model = keep.pop("path") if keep is not None else None
            if serve is not None:
                serve.kmeans(km_model, X_km)
                if lanes is not None:
                    lanes.kmeans(km_model, X_km)
                    lanes.autoscale(km_model, X_km)
            if mesh_parts is not None:
                mesh_part("kmeans", mesh_kmeans_part, torch, port, nc, wrappers, X_km, km_model)
            del km_model
            if spark_parts is not None:
                spark_part("fits", spark_fit_parts, torch, port, wrappers, X_km)
        if "path_stream" in phases:
            stream_parts["kmeans"] = stream_kmeans_part(torch, port, wrappers, dev, X_km)
            port.clear_fit_cache()
        del X_km

    rf_phases = {"kernels_forest", "path_rf_clf", "path_rf_reg", "path_cv_rf"} & set(phases)
    if rf_phases:
        t0 = time.perf_counter()
        X_rf, y_rf = classification_data(RF_ROWS + RF_HOLDOUT, COLS, SEED)
        emit({"phase": "rf_data", "rows": RF_ROWS + RF_HOLDOUT, "cols": COLS, "seconds": time.perf_counter() - t0})
    if "kernels_forest" in phases:
        results["kernels_forest"] = check_forest_kernels(torch, port, binning, fh, _build, X_rf, dev)
        emit(results["kernels_forest"])
    if "path_rf_clf" in phases:
        results["path_rf_clf"] = run_rf_path(torch, port, wrappers, "path_rf_clf",
                                             port.RandomForestClassifier(**RF_CLF), X_rf, y_rf, True, keep)
        emit(results["path_rf_clf"])
        if serve is not None:
            serve.forest(keep.pop("path_rf_clf"), X_rf[:RF_ROWS])
    if "path_rf_reg" in phases:
        y_reg = regression_target(X_rf, SEED + 3)
        results["path_rf_reg"] = run_rf_path(torch, port, wrappers, "path_rf_reg",
                                             port.RandomForestRegressor(**RF_REG), X_rf, y_reg, False)
        emit(results["path_rf_reg"])
        if mesh_parts is not None:
            mesh_part("rf_reg", mesh_rf_part, torch, port, wrappers, X_rf, y_reg)
    if "path_cv_rf" in phases:
        # the regressor's rows, while they exist (the phase is listed with
        # the model-selection phases)
        results["path_cv_rf"] = run_cv_rf_path(torch, port, wrappers, X_rf, regression_target(X_rf, SEED + 3))
        emit(results["path_cv_rf"])
    if rf_phases:
        del X_rf
    if "forest_card_vs_cpu" in phases:
        emit(forest_card_vs_cpu(torch, port))

    if "kernels_knn" in phases:
        results["kernels_knn"] = check_knn_kernels(torch, kk, nc, knn_ops, _build, dev)
        emit(results["kernels_knn"])
    if "kernels_exchange" in phases:
        results["kernels_exchange"] = check_exchange_kernel(torch, ek, topology, dev)
        emit(results["kernels_exchange"])
        emit(check_exchange_peer(torch, ek, topology))
    if "path_knn" in phases:
        t0 = time.perf_counter()
        X_knn = normal_data(KNN_ITEMS, COLS, KNN_ITEM_SEED)
        Q_knn = normal_data(KNN_QUERIES, COLS, KNN_QUERY_SEED)
        emit({"phase": "knn_data", "items": KNN_ITEMS, "queries": KNN_QUERIES, "cols": COLS,
              "seconds": time.perf_counter() - t0})
        results["path_knn"], knn_model, knn_idx, knn_dist = run_knn_path(
            torch, port, knn_ops, wrappers, X_knn, Q_knn, dev)
        emit(results["path_knn"])
        if serve is not None:
            serve.knn(knn_model, Q_knn)
        if "knn_audit" in phases:
            results["knn_audit"] = knn_audit(torch, knn_ops, wrappers, knn_model, Q_knn, knn_idx, knn_dist, dev)
            emit(results["knn_audit"])
        if "knn_streamed" in phases:
            emit(knn_streamed(torch, port, knn_ops, wrappers, X_knn, Q_knn, knn_model._staged_items[1],
                              knn_dist, dev))
        if "path_knn_mesh" in phases:
            results["path_knn_mesh"], mesh_prepared = run_knn_mesh_path(
                torch, port, knn_ops, wrappers, X_knn, Q_knn, knn_model._staged_items[1], knn_idx, knn_dist, dev,
                knn_ref)
            emit(results["path_knn_mesh"])
            if "knn_ring" in phases:
                results["knn_ring"] = knn_ring(torch, port, knn_ops, ek, wrappers, mesh_prepared,
                                               knn_model._staged_items[1], Q_knn, dev)
                emit(results["knn_ring"])
            del mesh_prepared
        if spark_parts is not None:
            del knn_model  # the card holds the barrier tasks' items instead
            torch.cuda.empty_cache()
            spark_part("knn", spark_knn_part, torch, port, knn_ops, kk, wrappers, X_knn, Q_knn[:RANKS_KNN_QUERIES],
                       knn_ref)
            results["path_spark"] = run_spark_path(spark_parts, spark_s, spark_wall)
            emit({k: v for k, v in results["path_spark"].items() if k != "parts"})
        else:
            del knn_model
        del X_knn

    if "kernels_ann" in phases:
        results["kernels_ann"] = check_ann_kernels(torch, pk, kk, nc, ivf, pq_mod, _build, dev)
        emit(results["kernels_ann"])
    ann_phases = [p for p in ANN_ARMS if p in phases]
    if ann_phases or "path_stream" in phases:
        t0 = time.perf_counter()
        X_ann, Q_ann = ann_data()
        emit({"phase": "ann_data", "items": ANN_ITEMS, "queries": ANN_QUERIES, "cols": ANN_COLS,
              "seconds": time.perf_counter() - t0})
        ann_mesh, ann_mesh_s = {}, {}
        for phase in ann_phases:
            results[phase] = run_ann_arm(torch, port, ivf, pq_mod, knn_ops, kk, wrappers, phase, X_ann, Q_ann, dev,
                                         keep)
            emit(results[phase])
            model = keep.pop(phase, None) if keep is not None else None
            mesh_ref = keep.pop(f"{phase}_mesh_ref", None) if keep is not None else None
            served = SERVE_ANN_ARMS.get(phase) if serve is not None else None
            if served is not None:
                serve.ann(served, model, Q_ann)
            if "path_ann_mesh" in phases:
                # the arm's model on 4 shards, after its one-shard paths
                t0 = time.perf_counter()
                ann_mesh[phase] = ann_mesh_arm(torch, port, ivf, wrappers, phase, model, Q_ann, mesh_ref, dev)
                ann_mesh_s[phase] = time.perf_counter() - t0
                emit({"phase": "path_ann_mesh", "part": phase, "seconds": ann_mesh_s[phase], **ann_mesh[phase]})
            del model, mesh_ref
        if ann_mesh:
            results["path_ann_mesh"] = run_ann_mesh_path(ann_mesh, ann_mesh_s)
            emit({k: v for k, v in results["path_ann_mesh"].items() if k != "parts"})
        if "path_stream" in phases:
            live_ref = {} if "path_live_mesh" in phases else None
            stream_parts["live_index"] = live_index_part(torch, port, ivf, pq_mod, knn_ops, kk, nc, wrappers, dev,
                                                         X_ann, Q_ann, serve, live_ref)
            if live_ref is not None:
                results["path_live_mesh"] = live_mesh_part(torch, port, wrappers, live_ref, Q_ann)
                emit(results["path_live_mesh"])
            del live_ref
        del X_ann, Q_ann

    if {"path_pca", "path_stream"} & set(phases):
        t0 = time.perf_counter()
        X_pca = low_rank_data(GLM_ROWS, GLM_COLS, PCA_RANK, PCA_SEED)
        gen_s = time.perf_counter() - t0
        if "path_pca" in phases:
            emit(run_pca_path(torch, port, wrappers, dev, X_pca, gen_s, keep))
            port.clear_fit_cache()
            pca_model = keep.pop("path_pca") if keep is not None else None
            pca_reference = keep.pop("path_pca_reference") if keep is not None else None
            if serve is not None:
                serve.glm("pca", pca_model, X_pca, ["pca_features"])
                if lanes is not None:
                    lanes.glm("pca", pca_model, X_pca)
            if mesh_parts is not None:
                mesh_part("pca", mesh_pca_part, torch, port, wrappers, X_pca, pca_reference)
            del pca_model, pca_reference
        if "path_stream" in phases:
            stream_parts["pca"] = stream_pca_part(torch, port, wrappers, X_pca)
            port.clear_fit_cache()
        del X_pca
    if {"path_linreg", "path_logreg", "path_cv_linreg", "path_cv_logreg", "path_stream"} & set(phases):
        t0 = time.perf_counter()
        X_glm, y_glm = glm_data()
        emit({"phase": "glm_data", "rows": GLM_ROWS + GLM_HOLDOUT, "cols": GLM_COLS,
              "seconds": time.perf_counter() - t0})
        if ranks_ref is not None:
            np.save(os.path.join(ranks_ref["job"], "y_glm.npy"), y_glm[:GLM_ROWS])
        if "path_linreg" in phases:
            emit(run_linreg_path(torch, port, wrappers, X_glm, y_glm, dev, keep))
            port.clear_fit_cache()
            lin_model = keep.pop("path_linreg") if keep is not None else None
            lin_reference = keep.pop("path_linreg_float64") if keep is not None else None
            if serve is not None:
                serve.glm("linreg", lin_model, X_glm, ["prediction"])
                if lanes is not None:
                    lanes.glm("linreg", lin_model, X_glm)
            if mesh_parts is not None:
                mesh_part("linreg", mesh_linreg_part, torch, port, wrappers, X_glm, y_glm, lin_reference)
            del lin_model, lin_reference
        if "path_logreg" in phases:
            emit(run_logreg_path(torch, port, wrappers, X_glm, y_glm, dev, keep))
            port.clear_fit_cache()
            log_model = keep.pop("path_logreg") if keep is not None else None
            if serve is not None:
                serve.glm("logreg", log_model, X_glm, ["prediction", "probability", "rawPrediction"])
                if lanes is not None:
                    lanes.glm("logreg", log_model, X_glm)
            if mesh_parts is not None:
                mesh_part("logreg", mesh_logreg_part, torch, port, wrappers, X_glm, y_glm, log_model)
            del log_model
        # the model-selection phases on the same rows (listed after the
        # other GLM phases)
        if "path_cv_linreg" in phases:
            results["path_cv_linreg"] = run_cv_linreg_path(torch, port, wrappers, X_glm, y_glm, dev)
            emit(results["path_cv_linreg"])
        if "path_cv_logreg" in phases:
            results["path_cv_logreg"] = run_cv_logreg_path(torch, port, wrappers, X_glm, y_glm, dev)
            emit(results["path_cv_logreg"])
        if "path_stream" in phases:
            port.clear_fit_cache()
            stream_parts["linreg"] = stream_linreg_part(torch, port, wrappers, X_glm, y_glm)
            port.clear_fit_cache()
            stream_parts["logreg"] = stream_logreg_part(torch, port, wrappers, X_glm, y_glm)
            port.clear_fit_cache()
        del X_glm, y_glm
    if "path_logreg_sparse" in phases:
        emit(run_logreg_sparse_path(torch, port, wrappers, dev))
        port.clear_fit_cache()
    if "glm_card_vs_cpu" in phases:
        emit(glm_card_vs_cpu(torch, port))
        port.clear_fit_cache()
    if mesh_parts is not None:
        results["path_fit_mesh"] = run_fit_mesh_path(mesh_parts, mesh_s)
        emit(results["path_fit_mesh"])
    if "mesh_card_vs_cpu" in phases:
        results["mesh_card_vs_cpu"] = mesh_card_vs_cpu(torch, port, wrappers, fh,
                                                       ranks_ref["models"] if ranks_ref is not None else None)
        emit(results["mesh_card_vs_cpu"])
    if ranks_ref is not None:
        results["path_fit_ranks"] = run_fit_ranks_path(torch, port, wrappers, ranks_ref, results["path_fit_mesh"],
                                                       results["path_knn_mesh"], smi)
        emit(results["path_fit_ranks"])
        del ranks_ref
    if "ann_mesh_card_vs_cpu" in phases:
        results["ann_mesh_card_vs_cpu"] = ann_mesh_card_vs_cpu(torch, port, ivf, pq_mod, knn_ops, wrappers, dev)
        emit(results["ann_mesh_card_vs_cpu"])
    if "cv_card_vs_cpu" in phases:
        results["cv_card_vs_cpu"] = cv_card_vs_cpu(torch, port, wrappers)
        emit(results["cv_card_vs_cpu"])
    if "path_umap" in phases:
        umap_mesh = {} if "path_umap_mesh" in phases else None
        results["path_umap"] = run_umap_path(torch, port, knn_ops, kk, nc, wrappers, dev, umap_mesh)
        emit(results["path_umap"])
        if umap_mesh is not None:
            results["path_umap_mesh"] = umap_mesh["rec"]
            emit(results["path_umap_mesh"])
    if "umap_card_vs_cpu" in phases:
        emit(umap_card_vs_cpu(torch, port, knn_ops, dev))
    if "path_stream" in phases:
        results["path_stream"] = run_stream_path(stream_parts)
        emit(results["path_stream"])
        port.clear_fit_cache()
    if "stream_card_vs_cpu" in phases:
        emit(stream_card_vs_cpu(torch, port, wrappers))
    if serve is not None:
        serve.close()
        results["path_serve"] = serve.record(smi)
        emit(results["path_serve"])
    if lanes is not None:
        results["path_serve_lanes"] = lanes.record(smi)
        emit(results["path_serve_lanes"])

    print(smi, flush=True)
    emit(summary(results, time.perf_counter() - t_start))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def summary(results, seconds):
    """The {"kernels": [...]} line: each kernel at the shape the main path
    gives it most often, with the launches of the path that runs it."""
    rows = []
    km, kf = results.get("kernels"), results.get("kernels_forest")
    if km is not None:
        rows.append({
            "name": "min_dist_argmin", "route": "cuda", "source": KERNEL_SOURCES["min_dist_argmin"],
            "replaces": "spark_rapids_ml_tpu/ops/pallas_tpu.py:102",
            "launches": results.get("path", {}).get("launches_all", {}).get("min_dist_argmin"),
            "max_abs_err": km["max_abs_err"], "ms": km["kernel_ms"], "plain_ms": km["plain_ms"],
            "bound_ms": km["bound_ms"], "bound_by": km["bound_by"], "library_ms": km["library_ms"],
            "shape": [km["n"], km["d"], km["k"]],
        })
    if kf is not None:
        clf = results.get("path_rf_clf", {}).get("launches", {})
        reg = results.get("path_rf_reg", {}).get("launches", {})
        r = kf["bin_features_fm"][0]
        rows.append({
            "name": "bin_features_fm", "route": "cuda", "source": KERNEL_SOURCES["bin_features_fm"],
            "replaces": "spark_rapids_ml_tpu/ops/pallas_tpu.py:219", "launches": clf.get("bin_features_fm"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r[k] for k in ("n", "d", "edges", "n_pad")],
        })
        # B3 at the classifier's level 0 (tensor-core route) and level 6
        # (the atomic route's most frequent launch), launches by route
        clf_levels = {r["level"]: r for r in kf["node_histograms_levels"] if r["path"] == "clf"}
        by_route = {route: {"path_rf_clf": clf.get(f"node_histograms_{route}"),
                            "path_rf_reg": reg.get(f"node_histograms_{route}")} for route in ("mma", "atomic")}
        # (the classifier declares its stats integers: the atomic route's
        # int32 cells)
        for name, r in (("node_histograms_mma", clf_levels[0]), ("node_histograms_atomic", clf_levels[max(clf_levels)])):
            route = name.rsplit("_", 1)[1]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
                "replaces": "spark_rapids_ml_tpu/ops/forest_hist.py:73", "launches": clf.get(name),
                "max_abs_err": r[f"max_abs_err_{route}"],
                "ms": r["atomic_int_ms"] if route == "atomic" else r["mma_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": [r[k] for k in ("f_pad", "n", "t_pack", "nodes", "s_dim", "n_bins")],
                "launches_by_route": by_route,
            })
        r = kf["node_histograms_bucketed"][0]
        rows.append({
            "name": "node_histograms_bucketed", "route": "cuda", "source": KERNEL_SOURCES["node_histograms_bucketed"],
            "replaces": "spark_rapids_ml_tpu/ops/forest_hist.py:182", "launches": clf.get("node_histograms_bucketed"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r[k] for k in ("f_pad", "n", "t_pack_or_buckets", "nodes", "s_dim", "n_bins")],
        })
    kn = results.get("kernels_knn")
    if kn is not None:
        path = results.get("path_knn", {}).get("launches", {})
        audit = results.get("knn_audit", {}).get("launches", {})
        picks = (
            ("knn_candidates", "spark_rapids_ml_tpu/ops/pallas_knn.py:212", path),
            ("knn_candidates_audit", "spark_rapids_ml_tpu/ops/pallas_knn.py:191", audit),
            ("knn_fused_merge", "spark_rapids_ml_tpu/ops/pallas_knn.py:544", path),
            ("knn_count", "spark_rapids_ml_tpu/ops/pallas_knn.py:308", audit),
        )
        mesh = results.get("path_knn_mesh", {}).get("launches", {})
        umap_launches = results.get("path_umap", {}).get("launches", {})
        for name, replaces, launches in picks:
            r = kn[name]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name], "replaces": replaces,
                "launches": launches.get(name), "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": [r["n"], r["d"], r["q"], r["m"], r["k"]],
                "launches_mesh": mesh.get(name), "launches_umap": umap_launches.get(name),
            })
    umap_kernels = results.get("path_umap", {}).get("kernels")
    if umap_kernels is not None:
        # B5 and B7 at the UMAP self-join's launch shape
        for row in rows:
            r = umap_kernels.get(row["name"])
            if r is not None:
                row["umap_shape"] = {key: r[key] for key in ("n", "d", "q", "m", "k", "pool", "kernel_ms", "plain_ms",
                                                             "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    ka = results.get("kernels_ann")
    merge_row = next((row for row in rows if row["name"] == "knn_fused_merge"), None)
    if ka is not None and merge_row is not None:
        # B7 at the ANN arms' pools, each k with the launches of its arm
        arms = dict(zip(ANN_MERGE_KS, ANN_ARMS))
        merge_row["ann_pool"] = [
            {key: r[key] for key in ("q", "pool", "k", "route", "kernel_ms", "window_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}
            | {"launches": results.get(arms[r["k"]], {}).get("launches", {}).get("knn_fused_merge"),
               "arm": arms[r["k"]]}
            for r in ka["knn_fused_merge_ann"] if not r["tied"]
        ]
    if ka is not None:
        for name, arm in (("lut_accumulate_probed", "path_ann_pq"), ("fastscan_lut_accumulate_probed", "path_ann_pq4")):
            r = ka[name]
            rows.append({
                "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
                "replaces": {"lut_accumulate_probed": "spark_rapids_ml_tpu/ops/pallas_pq.py:60",
                             "fastscan_lut_accumulate_probed": "spark_rapids_ml_tpu/ops/pallas_pq.py:170"}[name],
                "launches": results.get(arm, {}).get("launches", {}).get(name), "max_abs_err": r["max_abs_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": [r["b"], r["r"], r["m_sub"], r["ksub"]],
            })
    ke = results.get("kernels_exchange")
    if ke is not None:
        r = ke["ring_shift"]
        rows.append({
            "name": "ring_shift", "route": "cuda", "source": KERNEL_SOURCES["ring_shift"],
            "replaces": "spark_rapids_ml_tpu/parallel/exchange.py:484",
            "launches": results.get("knn_ring", {}).get("launches_ring", {}).get("ring_shift"),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": [r["shards"], *r["shape"]],
        })
    # B1-B4's launches in the model-selection phases
    cv_launches = {phase: results[phase]["launches"] for phase in ("path_cv_rf",) if phase in results}
    if "cv_card_vs_cpu" in results:
        cv_launches["cv_card_vs_cpu"] = results["cv_card_vs_cpu"]["cases"]["kmeans"]["launches"]
    for row in rows:
        if row["name"] in ("min_dist_argmin", "bin_features_fm", "node_histograms_mma", "node_histograms_atomic",
                           "node_histograms_bucketed") and cv_launches:
            row["launches_model_selection"] = {phase: launches.get(row["name"])
                                               for phase, launches in cv_launches.items()}
        if row["name"] in ("min_dist_argmin", "knn_fused_merge") and "path_stream" in results:
            # B1 in the live index's adds, B7 in its searches
            row["launches_stream"] = results["path_stream"]["launches"][row["name"]]
        if row["name"] in SERVE_KERNELS and "path_serve" in results:
            # B1, B5, B7 and B9 in served batches
            row["launches_serve"] = results["path_serve"]["launches"][row["name"]]
        mesh = results.get("path_fit_mesh", {}).get("parts", {})
        if row["name"] == "min_dist_argmin" and "kmeans" in mesh:
            # B1 in the transform of the KMeans model fit on 4 shards
            row["launches_mesh"] = mesh["kmeans"]["transform_launches"]["min_dist_argmin"]
        if row["name"] == "bin_features_fm" and "rf_reg" in mesh:
            # B2 once a shard in the 4-shard forest fit
            row["launches_mesh"] = mesh["rf_reg"]["launches_fit"]["bin_features_fm"]
        if row["name"] in ("node_histograms_mma", "node_histograms_atomic") and "mesh_card_vs_cpu" in results:
            # B3 once a shard through node_histograms_sharded
            row["launches_mesh"] = results["mesh_card_vs_cpu"]["node_histograms_sharded"]["launches"][row["name"]]
        ann_mesh = {arm: part["launches"] for arm, part in results.get("path_ann_mesh", {}).get("parts", {}).items()}
        if row["name"] in ("knn_fused_merge", "lut_accumulate_probed", "fastscan_lut_accumulate_probed") and ann_mesh:
            # B7, B9 and B10 in the ANN arms' searches on 4 shards
            row["launches_ann_mesh"] = {arm: launches[row["name"]] for arm, launches in ann_mesh.items()}
        if row["name"] in ("min_dist_argmin", "knn_fused_merge") and "path_live_mesh" in results:
            # B1 in the 4-shard live index's adds, B7 in its searches
            row["launches_live_mesh"] = results["path_live_mesh"]["launches"][row["name"]]
        amc = results.get("ann_mesh_card_vs_cpu", {}).get("launches")
        if row["name"] in ("min_dist_argmin", "knn_fused_merge", "lut_accumulate_probed",
                           "fastscan_lut_accumulate_probed") and amc:
            row["launches_ann_mesh_card_vs_cpu"] = {cfg: launches[row["name"]] for cfg, launches in amc.items()
                                                    if cfg.startswith("card")}
        ranks_rec = results.get("path_fit_ranks")
        if ranks_rec is not None and row["name"] in ("min_dist_argmin", "bin_features_fm", "knn_candidates",
                                                     "knn_fused_merge"):
            # each path_fit_ranks worker's launches (B2 in its forest fit, B5 /
            # B7 in its kNN searches), and B1 in the parent's transform
            row["launches_ranks"] = {rank: launches.get(row["name"], 0)
                                     for rank, launches in ranks_rec["launches_ranks"].items()}
            if row["name"] == "min_dist_argmin":
                row["launches_ranks"]["parent_transform"] = ranks_rec["kmeans_transform"]["launches"][row["name"]]
        spark = results.get("path_spark", {}).get("parts", {})
        if row["name"] == "min_dist_argmin" and "kmeans_transform" in spark:
            # B1 once a partition in the executor transform
            row["launches_spark"] = spark["kmeans_transform"]["launches"]["min_dist_argmin"]
        if row["name"] in ("knn_candidates", "knn_fused_merge") and "knn" in spark:
            # B5 and B7 in each barrier task of the Spark kneighbors
            row["launches_spark"] = {"total": spark["knn"]["launches"][row["name"]],
                                     "by_task": {t: v[row["name"]] for t, v in spark["knn"]["launches_by_task"].items()}}
        if row["name"] == "min_dist_argmin" and "path_serve_lanes" in results:
            # B1 once per distinct lane of a multiplexed KMeans batch
            lanes_rec = results["path_serve_lanes"]
            row["launches_serve_lanes"] = lanes_rec["launches"]["min_dist_argmin"]
            row["lanes_per_kmeans_batch"] = lanes_rec["lanes_per_kmeans_batch"]
    return {"kernels": rows, "seconds": seconds}


PHASES = ["kernels", "path", "kernels_forest", "path_rf_clf", "path_rf_reg", "forest_card_vs_cpu",
          "kernels_knn", "kernels_exchange", "path_knn", "knn_audit", "knn_streamed", "path_knn_mesh", "knn_ring",
          "kernels_ann", "path_ann", "path_ann_pq", "path_ann_pq4", *GLM_PHASES, *MESH_PHASES, *ANN_MESH_PHASES,
          "path_fit_ranks", *CV_PHASES, *UMAP_PHASES, *STREAM_PHASES, "path_serve", "path_serve_lanes", "path_spark"]
KERNEL_SOURCES = {
    "min_dist_argmin": "spark_rapids_ml_tpu_torch/csrc/min_dist_argmin.cu",
    "bin_features_fm": "spark_rapids_ml_tpu_torch/csrc/bin_features_fm.cu",
    "node_histograms_mma": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "node_histograms_atomic": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "node_histograms_bucketed": "spark_rapids_ml_tpu_torch/csrc/forest_hist.cu",
    "knn_candidates": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "knn_candidates_audit": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "knn_fused_merge": "spark_rapids_ml_tpu_torch/csrc/knn_merge.cu",
    "knn_count": "spark_rapids_ml_tpu_torch/csrc/knn_topm.cu",
    "lut_accumulate": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "lut_accumulate_probed": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "fastscan_lut_accumulate": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "fastscan_lut_accumulate_probed": "spark_rapids_ml_tpu_torch/csrc/pq_lut.cu",
    "ring_shift": "spark_rapids_ml_tpu_torch/csrc/ring_shift.cu",
}


if __name__ == "__main__":
    sys.exit(main())
