"""Small sizes of each cell for the CPU rehearsals (the mixes' shapes, the
configurations' widths cut to what a test run holds)."""

KMEANS = {"config": {"params": {"k": 8, "maxIter": 10},
                     "data": {"rows": 3000, "cols": 16, "centers": 8, "partitions": 4}}}
KNN = {"config": {"data": {"rows": 5000, "cols": 16, "partitions": 4}, "queries": {"cols": 16},
                  "params": {"k": 20}}}
SMALL = {
    "kmeans-fit": KMEANS,
    "knn-exact-batch": {**KNN, "traffic": {"rows_per_call": 256, "check_rows_per_frame": 32}},
    "knn-exact-online": {**KNN, "traffic": {"frames": 4}},
}
