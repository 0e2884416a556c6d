/* Exact dynamic-time-warping alignment (native data path).
 *
 * The MCD evaluation aligns MFCC sequences with exact DTW; the Python inner
 * loop is O(T1*T2) interpreted steps.  This C kernel computes the full cost
 * matrix and backtracks the optimal path ~100x faster, keeping evaluation
 * off the training critical path.  (The reference uses the approximate
 * `fastdtw` python package, utils/audio.py:155-159.)
 *
 * A copy of the JAX package's native/dtw.c.
 *
 * Built with: cc -O3 -shared -fPIC dtw.c -o libdtw.so -lm
 */

#include <float.h>
#include <math.h>
#include <stdlib.h>

/* moves: 0 = diagonal, 1 = up (advance x), 2 = left (advance y) */

/* DP + backtrack over a PRECOMPUTED distance matrix dist[t1*t2] (row-major).
 * The caller computes distances with BLAS-class matmuls (numpy), which is
 * far faster than scalar per-cell distance loops here. */
int dtw_path_from_dist(const float *dist, int t1, int t2,
                       int *path_x, int *path_y) {
    const int w = t2 + 1;
    double *cost = (double *)malloc(sizeof(double) * (size_t)(t1 + 1) * w);
    unsigned char *move =
        (unsigned char *)malloc(sizeof(unsigned char) * (size_t)t1 * t2);
    if (!cost || !move) {
        free(cost);
        free(move);
        return -1;
    }

    for (int j = 0; j <= t2; ++j) cost[j] = DBL_MAX;
    cost[0] = 0.0;

    for (int i = 1; i <= t1; ++i) {
        double *prev = cost + (size_t)(i - 1) * w;
        double *curr = cost + (size_t)i * w;
        const float *drow = dist + (size_t)(i - 1) * t2;
        curr[0] = DBL_MAX;
        for (int j = 1; j <= t2; ++j) {
            double best = prev[j - 1];
            unsigned char m = 0;
            if (prev[j] < best) { best = prev[j]; m = 1; }
            if (curr[j - 1] < best) { best = curr[j - 1]; m = 2; }
            curr[j] = (double)drow[j - 1] + best;
            move[(size_t)(i - 1) * t2 + (j - 1)] = m;
        }
    }

    int len = 0;
    int i = t1, j = t2;
    while (i > 0 && j > 0) {
        path_x[len] = i - 1;
        path_y[len] = j - 1;
        ++len;
        unsigned char m = move[(size_t)(i - 1) * t2 + (j - 1)];
        if (m == 0) { --i; --j; }
        else if (m == 1) { --i; }
        else { --j; }
    }
    while (i > 0) { path_x[len] = --i; path_y[len] = 0; ++len; }
    while (j > 0) { path_x[len] = 0; path_y[len] = --j; ++len; }

    for (int a = 0, b = len - 1; a < b; ++a, --b) {
        int tx = path_x[a]; path_x[a] = path_x[b]; path_x[b] = tx;
        int ty = path_y[a]; path_y[a] = path_y[b]; path_y[b] = ty;
    }

    free(cost);
    free(move);
    return len;
}

/* Compute the optimal alignment path between frame sequences
 *   x: [t1, d]  y: [t2, d]  (row-major float32)
 * Writes path indices into path_x / path_y (capacity >= t1 + t2) and
 * returns the path length, or -1 on allocation failure. */
int dtw_path(const float *x, const float *y, int t1, int t2, int d,
             int *path_x, int *path_y) {
    const int w = t2 + 1;
    double *cost = (double *)malloc(sizeof(double) * (size_t)(t1 + 1) * w);
    unsigned char *move =
        (unsigned char *)malloc(sizeof(unsigned char) * (size_t)t1 * t2);
    if (!cost || !move) {
        free(cost);
        free(move);
        return -1;
    }

    for (int j = 0; j <= t2; ++j) cost[j] = DBL_MAX;
    cost[0] = 0.0;

    for (int i = 1; i <= t1; ++i) {
        double *prev = cost + (size_t)(i - 1) * w;
        double *curr = cost + (size_t)i * w;
        const float *xi = x + (size_t)(i - 1) * d;
        curr[0] = DBL_MAX;
        for (int j = 1; j <= t2; ++j) {
            const float *yj = y + (size_t)(j - 1) * d;
            double dist = 0.0;
            for (int k = 0; k < d; ++k) {
                double diff = (double)xi[k] - (double)yj[k];
                dist += diff * diff;
            }
            dist = sqrt(dist);

            double best = prev[j - 1];
            unsigned char m = 0;
            if (prev[j] < best) { best = prev[j]; m = 1; }
            if (curr[j - 1] < best) { best = curr[j - 1]; m = 2; }
            curr[j] = dist + best;
            move[(size_t)(i - 1) * t2 + (j - 1)] = m;
        }
    }

    /* backtrack (reversed), then flip in place */
    int len = 0;
    int i = t1, j = t2;
    while (i > 0 && j > 0) {
        path_x[len] = i - 1;
        path_y[len] = j - 1;
        ++len;
        unsigned char m = move[(size_t)(i - 1) * t2 + (j - 1)];
        if (m == 0) { --i; --j; }
        else if (m == 1) { --i; }
        else { --j; }
    }
    while (i > 0) { path_x[len] = --i; path_y[len] = 0; ++len; }
    while (j > 0) { path_x[len] = 0; path_y[len] = --j; ++len; }

    for (int a = 0, b = len - 1; a < b; ++a, --b) {
        int tx = path_x[a]; path_x[a] = path_x[b]; path_x[b] = tx;
        int ty = path_y[a]; path_y[a] = path_y[b]; path_y[b] = ty;
    }

    free(cost);
    free(move);
    return len;
}
