/* Minimal mrsFAST Common.h replacement for building the reference
 * CircMiner binary as a PARITY ORACLE (the repo's lib/mrsfast submodule
 * is empty).  The API surface is reconstructed purely from the call
 * sites in the reference's own sources (src/mrsfast/HashTable.c,
 * Sort.c/h, src/common.cpp:6-15, src/match_read.cpp:301-332) — see
 * SURVEY.md "Submodule caveat".  This is test harness code, not part of
 * the circminer_jax framework.
 */
#ifndef __MRSFAST_COMMON_STUB__
#define __MRSFAST_COMMON_STUB__

#include <stdio.h>
#include <stdlib.h>
#include <zlib.h>

#define CONTIG_NAME_SIZE 200

/* 3-bit packed sequence words: 21 bases per 64-bit word, first base in
 * bits 62..60 (pinned by match_read.cpp:313-327: `crdata <<= 3*pass`
 * then `(crdata >> 60) & 7`). */
typedef unsigned long long CompressedSeq;
typedef short CheckSumType;

typedef struct {
    unsigned int info;       /* location (1-based), or count in slot 0 */
    CheckSumType checksum;   /* next checkSumLength bases, 2-bit packed */
} GeneralIndex;

#ifdef __cplusplus
extern "C" {
#endif

/* globals defined by the reference itself (src/common.cpp:6-15) */
extern unsigned char WINDOW_SIZE;
extern char checkSumLength;
extern unsigned int CONTIG_SIZE;
extern unsigned int CONTIG_MAX_SIZE;
extern unsigned int THREAD_COUNT;
extern int THREAD_ID[255];
extern int SNPMode;
extern int pairedEndMode;
/* defined in HashTable.c */
extern int MAX_GENOME_INFO_SIZE;
/* mrsFAST read-length global; only referenced by the dead countQGrams
 * worker in the vendored HashTable.c (never called by CircMiner) */
extern int SEQ_LENGTH;

FILE *fileOpen(char *fileName, const char *mode);
double getTime(void);
void *getMem(size_t size);
void freeMem(void *ptr, size_t size);
unsigned int calculateCompressedLen(unsigned int normalLen);
/* 2-bit packed value of the first WINDOW_SIZE / checkSumLength bases
 * (A0 C1 G2 T3); -1 on any other character.  Must mirror the packing
 * in calculateHashTableOnFly (HashTable.c:786-797). */
int hashVal(char *seq);
int checkSumVal(char *seq);
/* mrsFAST one-time init; nothing the CircMiner paths read is set up
 * here, so the replacement is a no-op */
void initCommon(void);
/* 3-bit pack a sequence into CompressedSeq words (21 bases/word, first
 * base in bits 62..60 — the layout pac2char_otf decodes,
 * match_read.cpp:313-327); non-ACGT packs as 4 (N). */
void compressSequence(char *seq, unsigned int len, CompressedSeq *out);

#ifdef __cplusplus
}
#endif

#endif
