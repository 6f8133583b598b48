// Ogg/Vorbis read and write for svecalign_tpu_torch (utils/audio_io.py).
//
// The Vorbis half of the JAX package's native/audio_io.cpp, kept as the
// port's own copy (the port loads nothing of native/): the same
// libvorbisfile decode and libvorbis/libvorbisenc/libogg encode calls, so
// the same input decodes to the same floats and encodes to the same bytes.
// WAV is read and written by numpy in the port.
//
// Built with g++ at first use and linked against the system's
// libvorbisfile.so.3, libvorbisenc.so.2, libvorbis.so.0 and libogg.so.0.
// The image has no vorbis dev headers, so the few ABI entry points used
// here are declared by hand below; opaque library states are allocated as
// oversized blobs (the ABI has been stable for two decades).

#include <cstdint>
#include <cstdio>
#include <cstring>

// ---------------------------------------------------------------------------
// Minimal libogg/libvorbis ABI declarations
// ---------------------------------------------------------------------------

extern "C" {

typedef int64_t ogg_int64_t;

// layouts that we must read/write directly (stable public ABI)
typedef struct {
  unsigned char *packet;
  long bytes;
  long b_o_s;
  long e_o_s;
  ogg_int64_t granulepos;
  ogg_int64_t packetno;
} ogg_packet;

typedef struct {
  unsigned char *header;
  long header_len;
  unsigned char *body;
  long body_len;
} ogg_page;

typedef struct {
  int version;
  int channels;
  long rate;
  // ... remainder opaque (bitrate fields, codec_setup)
  long _pad[8];
  void *_codec_setup;
} vorbis_info_view;  // used read-only via ov_info()

// opaque state blobs, allocated generously oversized
struct OpaqueBlob512 { unsigned char _b[512]; };
struct OpaqueBlob1k { unsigned char _b[1024]; };
struct OpaqueBlob2k { unsigned char _b[2048]; };
struct OpaqueBlob8k { unsigned char _b[8192]; };

typedef OpaqueBlob8k OggVorbis_File;     // real size ~944B
typedef OpaqueBlob1k ogg_stream_state;   // real size ~408B
typedef OpaqueBlob1k vorbis_info;        // real size ~48B
typedef OpaqueBlob1k vorbis_comment;     // real size ~32B
typedef OpaqueBlob2k vorbis_dsp_state;   // real size ~160B
typedef OpaqueBlob2k vorbis_block;       // real size ~192B

// libvorbisfile (decode)
int ov_fopen(const char *path, OggVorbis_File *vf);
void *ov_info(OggVorbis_File *vf, int link);
ogg_int64_t ov_pcm_total(OggVorbis_File *vf, int link);
int ov_pcm_seek(OggVorbis_File *vf, ogg_int64_t pos);
long ov_read_float(OggVorbis_File *vf, float ***pcm_channels, int samples,
                   int *bitstream);
int ov_clear(OggVorbis_File *vf);

// libvorbis / libvorbisenc / libogg (encode)
void vorbis_info_init(vorbis_info *vi);
void vorbis_info_clear(vorbis_info *vi);
int vorbis_encode_init_vbr(vorbis_info *vi, long channels, long rate,
                           float base_quality);
void vorbis_comment_init(vorbis_comment *vc);
void vorbis_comment_clear(vorbis_comment *vc);
int vorbis_analysis_init(vorbis_dsp_state *v, vorbis_info *vi);
int vorbis_block_init(vorbis_dsp_state *v, vorbis_block *vb);
int vorbis_analysis_headerout(vorbis_dsp_state *v, vorbis_comment *vc,
                              ogg_packet *op, ogg_packet *op_comm,
                              ogg_packet *op_code);
float **vorbis_analysis_buffer(vorbis_dsp_state *v, int vals);
int vorbis_analysis_wrote(vorbis_dsp_state *v, int vals);
int vorbis_analysis_blockout(vorbis_dsp_state *v, vorbis_block *vb);
int vorbis_analysis(vorbis_block *vb, ogg_packet *op);
int vorbis_bitrate_addblock(vorbis_block *vb);
int vorbis_bitrate_flushpacket(vorbis_dsp_state *vd, ogg_packet *op);
int vorbis_block_clear(vorbis_block *vb);
void vorbis_dsp_clear(vorbis_dsp_state *v);

int ogg_stream_init(ogg_stream_state *os, int serialno);
int ogg_stream_packetin(ogg_stream_state *os, ogg_packet *op);
int ogg_stream_pageout(ogg_stream_state *os, ogg_page *og);
int ogg_stream_flush(ogg_stream_state *os, ogg_page *og);
int ogg_stream_clear(ogg_stream_state *os);
int ogg_page_eos(const ogg_page *og);

}  // extern "C"

extern "C" {

// Query sample rate / frames / channels of an .ogg file. Returns 0 on
// success.
int sva_ogg_info(const char *path, int *sample_rate, int64_t *frames,
                 int *channels) {
  OggVorbis_File vf;
  if (ov_fopen(path, &vf) != 0) return -1;
  vorbis_info_view *vi = (vorbis_info_view *)ov_info(&vf, -1);
  *sample_rate = (int)vi->rate;
  *channels = vi->channels;
  *frames = ov_pcm_total(&vf, -1);
  ov_clear(&vf);
  return 0;
}

// Read [start, start+count) frames of an .ogg file as interleaved float32
// into out. Returns frames read, or negative on error.
int64_t sva_ogg_read(const char *path, int64_t start, int64_t count,
                     float *out) {
  OggVorbis_File vf;
  if (ov_fopen(path, &vf) != 0) return -1;
  vorbis_info_view *vi = (vorbis_info_view *)ov_info(&vf, -1);
  int ch = vi->channels;
  if (ov_pcm_seek(&vf, start) != 0) {
    ov_clear(&vf);
    return -3;
  }
  int64_t done = 0;
  int bitstream = 0;
  while (done < count) {
    float **pcm;
    long want = (long)((count - done) > 4096 ? 4096 : (count - done));
    long got = ov_read_float(&vf, &pcm, want, &bitstream);
    if (got <= 0) break;  // EOF or hole
    for (long i = 0; i < got; ++i)
      for (int c = 0; c < ch; ++c) out[(done + i) * ch + c] = pcm[c][i];
    done += got;
  }
  ov_clear(&vf);
  return done;
}

// Write interleaved float32 frames as an Ogg/Vorbis file (VBR).
// Returns 0 on success. Classic libvorbis encode loop.
int sva_ogg_write(const char *path, const float *data, int64_t frames,
                  int channels, int sample_rate, float quality) {
  vorbis_info vi;
  vorbis_info_init(&vi);
  if (vorbis_encode_init_vbr(&vi, channels, sample_rate, quality) != 0) {
    vorbis_info_clear(&vi);
    return -1;
  }

  vorbis_comment vc;
  vorbis_comment_init(&vc);
  vorbis_dsp_state vd;
  vorbis_analysis_init(&vd, &vi);
  vorbis_block vb;
  vorbis_block_init(&vd, &vb);

  ogg_stream_state os;
  ogg_stream_init(&os, 0x53564100);  // arbitrary fixed serial ("SVA")

  FILE *f = fopen(path, "wb");
  if (!f) {
    ogg_stream_clear(&os);
    vorbis_block_clear(&vb);
    vorbis_dsp_clear(&vd);
    vorbis_comment_clear(&vc);
    vorbis_info_clear(&vi);
    return -2;
  }

  ogg_packet header, header_comm, header_code;
  vorbis_analysis_headerout(&vd, &vc, &header, &header_comm, &header_code);
  ogg_stream_packetin(&os, &header);
  ogg_stream_packetin(&os, &header_comm);
  ogg_stream_packetin(&os, &header_code);

  ogg_page og;
  while (ogg_stream_flush(&os, &og) != 0) {
    fwrite(og.header, 1, og.header_len, f);
    fwrite(og.body, 1, og.body_len, f);
  }

  const int64_t CHUNK = 4096;
  int64_t pos = 0;
  bool eos = false;
  while (!eos) {
    int64_t n = frames - pos;
    if (n > CHUNK) n = CHUNK;
    if (n > 0) {
      float **buffer = vorbis_analysis_buffer(&vd, (int)n);
      for (int64_t i = 0; i < n; ++i)
        for (int c = 0; c < channels; ++c)
          buffer[c][i] = data[(pos + i) * channels + c];
    }
    vorbis_analysis_wrote(&vd, (int)(n > 0 ? n : 0));
    pos += n;

    while (vorbis_analysis_blockout(&vd, &vb) == 1) {
      vorbis_analysis(&vb, nullptr);
      vorbis_bitrate_addblock(&vb);
      ogg_packet op;
      while (vorbis_bitrate_flushpacket(&vd, &op) == 1) {
        ogg_stream_packetin(&os, &op);
        while (!eos && ogg_stream_pageout(&os, &og) != 0) {
          fwrite(og.header, 1, og.header_len, f);
          fwrite(og.body, 1, og.body_len, f);
          if (ogg_page_eos(&og)) eos = true;
        }
      }
    }
    if (pos >= frames && n <= 0) {
      // vorbis_analysis_wrote(vd, 0) above signalled EOS; drain pages
      while (ogg_stream_flush(&os, &og) != 0) {
        fwrite(og.header, 1, og.header_len, f);
        fwrite(og.body, 1, og.body_len, f);
      }
      eos = true;
    }
  }

  fclose(f);
  ogg_stream_clear(&os);
  vorbis_block_clear(&vb);
  vorbis_dsp_clear(&vd);
  vorbis_comment_clear(&vc);
  vorbis_info_clear(&vi);
  return 0;
}

}  // extern "C"
