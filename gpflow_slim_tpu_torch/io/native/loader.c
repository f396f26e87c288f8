/* Native data loader of gpflow_slim_tpu_torch.io: pread-based row gather
 * with a background prefetch thread (the port's own copy of the JAX
 * package's loader, the same C API and file format).
 *
 * Feeds SVGP minibatches from disk without holding the dataset in host
 * RAM and without blocking the Python training loop on I/O: while the
 * caller computes on batch t, the worker thread reads batch t+1 (the
 * double-buffered loader). Compiled with ``cc -O2 -shared`` at first use
 * into build/loader/ (gpflow_slim_tpu_torch/io/dataset.py) and loaded by
 * ctypes.
 *
 * File format ("GFSB"): magic(4) | int64 rows | int64 cols | f32 data
 * row-major.
 *
 * C API:
 *   void* gfs_open(const char* path);            // NULL on error
 *   long  gfs_rows(void* h); long gfs_cols(void* h);
 *   int   gfs_gather(void* h, const long* idx, long n, float* out);
 *   int   gfs_prefetch_submit(void* h, const long* idx, long n);
 *   int   gfs_prefetch_wait(void* h, float* out, long n);
 *   void  gfs_close(void* h);
 */

#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

typedef struct {
    int fd;
    int64_t rows;
    int64_t cols;
    /* prefetch state */
    pthread_t thread;
    pthread_mutex_t mu;
    pthread_cond_t cv;
    int64_t *pending_idx;
    int64_t pending_n;
    float *buf;
    int64_t buf_n;
    int buf_ready;   /* 1 when buf holds a completed prefetch */
    int job_queued;  /* 1 when a job is waiting for the worker */
    int in_flight;   /* 1 while the worker reads into buf */
    int shutdown;
    int started;
} gfs_handle;

static const int64_t HDR = 4 + 8 + 8;

static int read_rows(gfs_handle *h, const int64_t *idx, int64_t n,
                     float *out) {
    const size_t row_bytes = (size_t)h->cols * sizeof(float);
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = idx[i];
        if (r < 0 || r >= h->rows) return -2;
        off_t off = (off_t)(HDR + (int64_t)row_bytes * r);
        ssize_t got = pread(h->fd, out + (size_t)i * h->cols, row_bytes, off);
        if (got != (ssize_t)row_bytes) return -3;
    }
    return 0;
}

static void *worker(void *arg) {
    gfs_handle *h = (gfs_handle *)arg;
    pthread_mutex_lock(&h->mu);
    for (;;) {
        while (!h->job_queued && !h->shutdown)
            pthread_cond_wait(&h->cv, &h->mu);
        if (h->shutdown) break;
        int64_t n = h->pending_n;
        int64_t *idx = h->pending_idx;
        h->job_queued = 0;
        h->in_flight = 1;
        pthread_mutex_unlock(&h->mu);

        int rc = read_rows(h, idx, n, h->buf);
        free(idx);

        pthread_mutex_lock(&h->mu);
        h->buf_n = (rc == 0) ? n : -1;
        h->buf_ready = 1;
        h->in_flight = 0;
        pthread_cond_broadcast(&h->cv);
    }
    pthread_mutex_unlock(&h->mu);
    return NULL;
}

void *gfs_open(const char *path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return NULL;
    char magic[4];
    int64_t dims[2];
    if (pread(fd, magic, 4, 0) != 4 || memcmp(magic, "GFSB", 4) != 0 ||
        pread(fd, dims, 16, 4) != 16) {
        close(fd);
        return NULL;
    }
    gfs_handle *h = (gfs_handle *)calloc(1, sizeof(gfs_handle));
    h->fd = fd;
    h->rows = dims[0];
    h->cols = dims[1];
    pthread_mutex_init(&h->mu, NULL);
    pthread_cond_init(&h->cv, NULL);
    return h;
}

long gfs_rows(void *hp) { return (long)((gfs_handle *)hp)->rows; }
long gfs_cols(void *hp) { return (long)((gfs_handle *)hp)->cols; }

int gfs_gather(void *hp, const long *idx, long n, float *out) {
    gfs_handle *h = (gfs_handle *)hp;
    /* long and int64_t are both 8 bytes on this platform */
    return read_rows(h, (const int64_t *)idx, (int64_t)n, out);
}

int gfs_prefetch_submit(void *hp, const long *idx, long n) {
    gfs_handle *h = (gfs_handle *)hp;
    pthread_mutex_lock(&h->mu);
    if (!h->started) {
        if (pthread_create(&h->thread, NULL, worker, h) != 0) {
            pthread_mutex_unlock(&h->mu);
            return -4;
        }
        h->started = 1;
    }
    if (h->job_queued) {  /* one outstanding job at a time */
        pthread_mutex_unlock(&h->mu);
        return -5;
    }
    while (h->in_flight) /* the worker still writes into buf */
        pthread_cond_wait(&h->cv, &h->mu);
    free(h->buf);
    h->buf = (float *)malloc((size_t)n * h->cols * sizeof(float));
    h->pending_idx = (int64_t *)malloc((size_t)n * sizeof(int64_t));
    memcpy(h->pending_idx, idx, (size_t)n * sizeof(int64_t));
    h->pending_n = n;
    h->buf_ready = 0;
    h->job_queued = 1;
    pthread_cond_broadcast(&h->cv);
    pthread_mutex_unlock(&h->mu);
    return 0;
}

int gfs_prefetch_wait(void *hp, float *out, long n) {
    gfs_handle *h = (gfs_handle *)hp;
    pthread_mutex_lock(&h->mu);
    while (!h->buf_ready)
        pthread_cond_wait(&h->cv, &h->mu);
    int rc = 0;
    if (h->buf_n != n) {
        rc = -6;
    } else {
        memcpy(out, h->buf, (size_t)n * h->cols * sizeof(float));
    }
    h->buf_ready = 0;
    pthread_mutex_unlock(&h->mu);
    return rc;
}

void gfs_close(void *hp) {
    gfs_handle *h = (gfs_handle *)hp;
    pthread_mutex_lock(&h->mu);
    h->shutdown = 1;
    pthread_cond_broadcast(&h->cv);
    pthread_mutex_unlock(&h->mu);
    if (h->started) pthread_join(h->thread, NULL);
    close(h->fd);
    free(h->buf);
    pthread_mutex_destroy(&h->mu);
    pthread_cond_destroy(&h->cv);
    free(h);
}
