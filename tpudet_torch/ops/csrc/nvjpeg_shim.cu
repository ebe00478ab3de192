// A plain C interface to nvJPEG, the CUDA toolkit's JPEG decoder, for
// tpudet_torch/ops/jpeg.py (ctypes). Built by ops/build.py with -lnvjpeg
// and an rpath to the toolkit's lib64.
//
// The card's counterpart of the decode in tpudet's native loader
// (tpudet/ops/native/jpeg_loader.cc:108-176, libjpeg on the host): the
// image decodes straight into a caller's (h, w, 3) uint8 buffer on the
// device, interleaved BGR (or RGB), on the caller's stream, with no host
// copy of the pixels. nvJPEG's default backend (NVJPEG_BACKEND_DEFAULT,
// nvjpegDecode) picks where the Huffman stage runs.
//
// One handle a process and one decoder state a thread that decodes (the
// wrapper keeps them). Every function returns nvJPEG's status (0 is
// NVJPEG_STATUS_SUCCESS); tpudet_nvjpeg_decode and the state's functions
// return 1000 + the cudaError_t of a CUDA call that failed.
//
// nvjpegDecode returns once its host stage is done and leaves the copies
// out of the state's pinned buffers queued on the stream. A decode that
// reuses the state before those copies ran overwrites what they read, and
// the earlier image comes out corrupt: it happens where the stream runs
// far behind the host, as on a card that other work keeps busy. So a
// state records an event after each decode and waits for it before the
// next one, and before it is destroyed.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stddef.h>

extern "C" {

int tpudet_nvjpeg_version(int* major, int* minor, int* patch) {
  int st = nvjpegGetProperty(MAJOR_VERSION, major);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = nvjpegGetProperty(MINOR_VERSION, minor);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  return nvjpegGetProperty(PATCH_LEVEL, patch);
}

int tpudet_nvjpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  const int st = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0,
                                &h);
  *handle = h;
  return st;
}

int tpudet_nvjpeg_destroy(void* handle) {
  return nvjpegDestroy(static_cast<nvjpegHandle_t>(handle));
}

struct State {
  nvjpegJpegState_t jpeg;
  cudaEvent_t done;  // recorded after the state's last decode
};

static int cuda_status(cudaError_t err) {
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

int tpudet_nvjpeg_state_create(void* handle, void** state) {
  *state = nullptr;
  State* s = new State{nullptr, nullptr};
  int st = nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle),
                                 &s->jpeg);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = cuda_status(cudaEventCreateWithFlags(&s->done,
                                              cudaEventDisableTiming));
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (s->jpeg != nullptr) nvjpegJpegStateDestroy(s->jpeg);
    delete s;
    return st;
  }
  *state = s;
  return st;
}

int tpudet_nvjpeg_state_destroy(void* state) {
  State* s = static_cast<State*>(state);
  int st = cuda_status(cudaEventSynchronize(s->done));
  cudaEventDestroy(s->done);
  const int jst = nvjpegJpegStateDestroy(s->jpeg);
  delete s;
  return st != 0 ? st : jst;
}

// Components, chroma subsampling (nvjpegChromaSubsampling_t) and the size
// of the first component, from the header.
int tpudet_nvjpeg_info(void* handle, const unsigned char* data, size_t len,
                       int* components, int* subsampling, int* height,
                       int* width) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  const int st = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data,
                                    len, components, &css, widths, heights);
  *subsampling = static_cast<int>(css);
  *height = heights[0];
  *width = widths[0];
  return st;
}

// Decode into out, (h, w, 3) uint8 at a row pitch of `pitch` bytes, on
// `stream`: BGR with bgr != 0, else RGB.
int tpudet_nvjpeg_decode(void* handle, void* state, const unsigned char* data,
                         size_t len, int bgr, void* out, size_t pitch,
                         void* stream) {
  State* s = static_cast<State*>(state);
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = pitch;
  // the state's previous decode has read its buffers (an event that was
  // never recorded is complete)
  int st = cuda_status(cudaEventSynchronize(s->done));
  if (st != 0) return st;
  st = nvjpegDecode(
      static_cast<nvjpegHandle_t>(handle), s->jpeg, data, len,
      bgr ? NVJPEG_OUTPUT_BGRI : NVJPEG_OUTPUT_RGBI, &img,
      static_cast<cudaStream_t>(stream));
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = cuda_status(cudaEventRecord(s->done,
                                   static_cast<cudaStream_t>(stream)));
  if (st != 0) return st;
  return cuda_status(cudaGetLastError());
}

}  // extern "C"
