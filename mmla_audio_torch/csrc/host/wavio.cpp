// Minimal PCM16 WAV reader/writer (RIFF) for the host runtime.
//
// Replaces the reference's wave/soundfile round-trips in the hot loop; used
// by the Python wavio module as a fast path for bulk segment IO.  Mono or
// first-channel extraction, 16-bit only (the reference asserts the same,
// record_on_pc.py:190-195).

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Returns number of samples read into *out (caller frees with wav_free), or
// negative on error. Writes sample rate to *sample_rate.
int64_t wav_read(const char* path, int16_t** out, int32_t* sample_rate) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char riff[4];
    uint32_t riff_size;
    char wave[4];
    if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
        std::fread(&riff_size, 4, 1, f) != 1 ||
        std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) {
        std::fclose(f);
        return -2;
    }
    uint16_t channels = 0, bits = 0;
    uint32_t rate = 0;
    int64_t n_samples = -1;
    int16_t* data = nullptr;
    while (true) {
        char id[4];
        uint32_t size;
        if (std::fread(id, 1, 4, f) != 4 || std::fread(&size, 4, 1, f) != 1)
            break;
        if (!std::memcmp(id, "fmt ", 4)) {
            uint16_t fmt;
            if (std::fread(&fmt, 2, 1, f) != 1) break;
            if (std::fread(&channels, 2, 1, f) != 1) break;
            if (std::fread(&rate, 4, 1, f) != 1) break;
            std::fseek(f, 6, SEEK_CUR);  // byte rate + block align
            if (std::fread(&bits, 2, 1, f) != 1) break;
            std::fseek(f, size - 16, SEEK_CUR);
            if (fmt != 1 || bits != 16) { std::fclose(f); return -3; }
        } else if (!std::memcmp(id, "data", 4)) {
            if (channels == 0) { std::fclose(f); return -4; }
            const uint32_t frames = size / (2 * channels);
            data = new int16_t[frames];
            if (channels == 1) {
                if (std::fread(data, 2, frames, f) != frames) {
                    delete[] data;
                    std::fclose(f);
                    return -5;
                }
            } else {
                int16_t* inter = new int16_t[size / 2];
                if (std::fread(inter, 2, size / 2, f) != size / 2) {
                    delete[] inter;
                    delete[] data;
                    std::fclose(f);
                    return -5;
                }
                for (uint32_t i = 0; i < frames; ++i)
                    data[i] = inter[i * channels];  // keep channel 0
                delete[] inter;
            }
            n_samples = frames;
            break;
        } else {
            std::fseek(f, size + (size & 1), SEEK_CUR);
        }
    }
    std::fclose(f);
    if (n_samples < 0) { delete[] data; return -6; }
    *out = data;
    *sample_rate = static_cast<int32_t>(rate);
    return n_samples;
}

void wav_free(int16_t* p) { delete[] p; }

int32_t wav_write(const char* path, const int16_t* samples, int64_t n,
                  int32_t sample_rate) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const uint32_t data_size = static_cast<uint32_t>(n * 2);
    const uint32_t riff_size = 36 + data_size;
    const uint16_t channels = 1, bits = 16, fmt = 1, block = 2;
    const uint32_t byte_rate = sample_rate * 2;
    const uint32_t fmt_size = 16;
    std::fwrite("RIFF", 1, 4, f);
    std::fwrite(&riff_size, 4, 1, f);
    std::fwrite("WAVE", 1, 4, f);
    std::fwrite("fmt ", 1, 4, f);
    std::fwrite(&fmt_size, 4, 1, f);
    std::fwrite(&fmt, 2, 1, f);
    std::fwrite(&channels, 2, 1, f);
    std::fwrite(&sample_rate, 4, 1, f);
    std::fwrite(&byte_rate, 4, 1, f);
    std::fwrite(&block, 2, 1, f);
    std::fwrite(&bits, 2, 1, f);
    std::fwrite("data", 1, 4, f);
    std::fwrite(&data_size, 4, 1, f);
    std::fwrite(samples, 2, n, f);
    std::fclose(f);
    return 0;
}

}  // extern "C"
