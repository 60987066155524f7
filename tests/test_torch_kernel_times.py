"""The parsers behind ``native/kernel_times.py``'s ptxas and SASS reports,
on canned tool output: they read text only, so they run on the CPU."""

from crypto_primitives_tpu_torch.native.kernel_times import parse_ptxas, parse_sass

_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13msm_sw_kernelILi12ELb1ELi3EEvPKjS1_PjPKjjxiii' for 'sm_90a'
ptxas info    : Function properties for _Z13msm_sw_kernelILi12ELb1ELi3EEvPKjS1_PjPKjjxiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z20permute_kernel_groupILi12ELi3ELi4EEvPKjPjPKjxiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z20permute_kernel_groupILi12ELi3ELi4EEvPKjPjPKjxiiiii
    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 456 bytes cmem[0]
"""

_SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

\tcode for sm_90a
\t\tFunction : one_mont_mul
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe20000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;             /* 0x0000000504027225 */
        /*0020*/                   IADD3.X R3, P0, R6, R7, RZ, P0, !PT ;      /* 0x0000000706037210 */
        /*0030*/              @P0  IADD3 R8, R9, 0x1, RZ ;                    /* 0x0000000109080810 */
        /*0040*/             @!P1  IMAD R10, R11, R12, R13 ;                  /* 0x0000000c0b0a9224 */
        /*0050*/             @!UP0 IMAD.HI.U32 R14, R15, R16, RZ ;           /* 0x000000100f0e8227 */
        /*0060*/                   NOP ;                                      /* 0x0000000000007918 */
        /*0070*/                   STG.E desc[UR4][R18.64], R2 ;              /* 0x0000000212007986 */
        /*0080*/                   EXIT ;                                     /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                                  /* 0xfffffffc00fc7947 */
\t\t..........

\t\tFunction : _Z9one_blockPKjPj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   SHF.R.U32.HI R0, RZ, 0x7, R3 ;             /* 0x00000007ff007819 */
        /*0010*/                   LOP3.LUT R1, R0, R2, R4, 0x96, !PT ;       /* 0x0000000200017212 */
        /*0020*/                   IADD3 R5, R1, R6, R7 ;                     /* 0x0000000601057210 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
\t\t..........
"""


def test_parse_ptxas_reads_registers_stack_and_spills():
    assert parse_ptxas(_PTXAS_LOG) == [
        {"kernel": "_Z13msm_sw_kernelILi12ELb1ELi3EEvPKjS1_PjPKjjxiii", "registers": 168, "stack": 0,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "_Z20permute_kernel_groupILi12ELi3ELi4EEvPKjPjPKjxiiiii", "registers": 96, "stack": 24,
         "spill_stores": 24, "spill_loads": 28},
    ]
    assert parse_ptxas("ptxas info    : 0 bytes gmem\n") == []


def test_parse_sass_counts_the_instruction_mix():
    mixes = parse_sass(_SASS)
    assert list(mixes) == ["one_mont_mul", "_Z9one_blockPKjPj"]
    # IMAD with any suffix or predicate: 3; IADD3 (.X, predicated): 2; LDC,
    # STG and EXIT: other; NOP and BRA are not counted
    assert mixes["one_mont_mul"] == {"IMAD": 3, "IADD3": 2, "other": 3, "total": 8}
    assert mixes["_Z9one_blockPKjPj"] == {"IMAD": 0, "IADD3": 1, "other": 3, "total": 4}
    assert parse_sass("no functions here") == {}
