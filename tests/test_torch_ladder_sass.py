"""``volrt_torch/bench/step_ab.py``'s readers of the build: the SASS
parser (opcode classes of each kernel variant and of its march loop, the
scatter opcodes) and the ptxas report, on canned ``cuobjdump -sass`` and
``nvcc -Xptxas -v`` text. CPU only: the card's toolkit makes the real
text."""
from __future__ import annotations

from volrt_torch.bench.step_ab import (
    OPCODE_CLASSES, issue_ms, march_loop, parse_sass, ptxas_report,
    sass_counts, variant_name)

LADDER = "_ZN12_GLOBAL__N_119march_ladder_kernelIfLb0ELb0ELb1EEEvN5volrt9MarchArgsEPKT_Pf"
L2 = "_ZN12_GLOBAL__N_114l2_step_kernelILb0ELb1ELb1ELb1EEEvN5volrt9MarchArgsEPKfPfNS1_8GradArgsE"
OTHER = "_ZN12_GLOBAL__N_119div255_check_kernelEPKfxPy"

# Two kernels of KERNELS and one that is not. The ladder's loop runs from
# 0x0080 to its backward branch at 0x01a0 (address form, with the
# predicate operand of the loop's exit test); the step's from
# the label .L_x_1 to its branch (label form), with a forward branch
# inside it.
SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : {LADDER}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.Y ;                            /* 0x0000000000007919 */
                                                                                 /* 0x000e220000002200 */
        /*0020*/                   LDS.128 R4, [R0] ;                            /* 0x0000000000047984 */
                                                                                 /* 0x000fe20000000c00 */
        /*0030*/                   ISETP.GE.AND P0, PT, R0, 0x100, PT ;          /* 0x000001000000780c */
                                                                                 /* 0x000fda0003f06270 */
        /*0040*/               @P0 EXIT ;                                        /* 0x000000000000094d */
                                                                                 /* 0x000fea0003800000 */
        /*0050*/                   MOV R2, R5 ;                                  /* 0x0000000500027202 */
                                                                                 /* 0x000fe20000000f00 */
        /*0060*/                   IMAD.MOV.U32 R3, RZ, RZ, R6 ;                 /* 0x000000ffff037224 */
                                                                                 /* 0x000fe400078e0006 */
        /*0070*/                   BSSY B0, 0x1c0 ;                              /* 0x0000014000007945 */
                                                                                 /* 0x000fe40003800000 */
        /*0080*/                   FMUL R8, R2, R3 ;                             /* 0x0000000302087220 */
                                                                                 /* 0x000fc80000400000 */
        /*0090*/                   FADD R8, R8, 1 ;                              /* 0x3f80000008087421 */
                                                                                 /* 0x000fc80000000000 */
        /*00a0*/                   FADD.RM R9, R8, 1.2582912e+07 ;               /* 0x4b40000008097421 */
                                                                                 /* 0x000fc80000004000 */
        /*00b0*/                   FFMA R10, -R9, 255, R8 ;                      /* 0x437f0000090a7423 */
                                                                                 /* 0x000fc80000000108 */
        /*00c0*/                   IADD3 R11, R9, -0x4b400000, RZ ;              /* 0xb4c000000b0b7810 */
                                                                                 /* 0x000fc80007ffe0ff */
        /*00d0*/                   VIMNMX R11, RZ, R11, !PT ;                    /* 0x0000000bff0b7248 */
                                                                                 /* 0x000fca0007fe0100 */
        /*00e0*/                   IMAD.WIDE.U32 R12, R11, 0x4, R14 ;            /* 0x000000040b0c7825 */
                                                                                 /* 0x000fcc00078e000e */
        /*00f0*/                   LDG.E.CONSTANT R16, desc[UR4][R12.64] ;       /* 0x000000040c107981 */
                                                                                 /* 0x000ea8000c1e9900 */
        /*0100*/                   LDS.128 R20, [R11+0x10] ;                     /* 0x0000100b14147984 */
                                                                                 /* 0x000fe80000000c00 */
        /*0110*/                   F2I.FLOOR.NTZ R17, R16 ;                      /* 0x0000001000117305 */
                                                                                 /* 0x004e240000207100 */
        /*0120*/                   I2FP.F32.U32 R18, R17 ;                       /* 0x0000001100127245 */
                                                                                 /* 0x001fca0000201000 */
        /*0130*/                   MUFU.RCP R19, R18 ;                           /* 0x0000001200137308 */
                                                                                 /* 0x000e240000001000 */
        /*0140*/                   PRMT R17, R16, 0x7654, R17 ;                  /* 0x0000765410117816 */
                                                                                 /* 0x000fe40000000011 */
        /*0150*/                   FSETP.GTU.AND P1, PT, R8, R3, PT ;            /* 0x000000030800720b */
                                                                                 /* 0x000fe40003f2c000 */
        /*0160*/                   NOP ;                                         /* 0x0000000000007918 */
                                                                                 /* 0x000fc80000000000 */
        /*0170*/                   ISETP.LT.AND P0, PT, R2, R4, PT ;             /* 0x000000040200720c */
                                                                                 /* 0x000fc80003f01270 */
        /*0180*/                   SEL R2, R2, RZ, P0 ;                          /* 0x000000ff02027207 */
                                                                                 /* 0x000fc80000000000 */
        /*0190*/                   FRND.FLOOR R3, R8 ;                           /* 0x0000000800037307 */
                                                                                 /* 0x000e240000205000 */
        /*01a0*/          @!P0 BRA P1, 0x80 ;                                    /* 0xfffffffc00b49947 */
                                                                                 /* 0x000fea000383ffff */
        /*01b0*/                   BSYNC B0 ;                                    /* 0x0000000000007941 */
                                                                                 /* 0x000fea0003800000 */
        /*01c0*/                   STG.E.128 desc[UR4][R2.64], R4 ;              /* 0x0000000402007986 */
                                                                                 /* 0x000fe2000c101d04 */
        /*01d0*/                   EXIT ;                                        /* 0x000000000000794d */
                                                                                 /* 0x000fea0003800000 */
        /*01e0*/                   BRA 0x1e0;                                    /* 0xfffffffc00fc7947 */
                                                                                 /* 0x000fc0000383ffff */
        /*01f0*/                   NOP;                                          /* 0x0000000000007918 */
                                                                                 /* 0x000fc00000000000 */
		..........


		Function : {OTHER}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;                  /* 0x0000000402027981 */
                                                                                 /* 0x000fe2000c1e1900 */
        /*0010*/                   ATOMG.E.ADD.64 PT, R4, desc[UR4][R6.64], R8 ; /* 0x000000080604798a */
                                                                                 /* 0x000fe200081ee5c4 */
        /*0020*/                   EXIT ;                                        /* 0x000000000000794d */
                                                                                 /* 0x000fea0003800000 */
		..........


		Function : {L2}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   S2R R0, SR_LANEID ;                           /* 0x0000000000007919 */
                                                                                 /* 0x000e220000000000 */
.L_x_1:
        /*0010*/                   MATCH.ANY R3, R2 ;                            /* 0x00000000020373a1 */
                                                                                 /* 0x000e2200000e8000 */
        /*0020*/                   SHFL.DOWN PT, R5, R4, 0x1, 0x1f ;             /* 0x08201f0004057f89 */
                                                                                 /* 0x000e2200000e0000 */
        /*0030*/              @!P0 BRA `(.L_x_2) ;                               /* 0x0000000000088947 */
                                                                                 /* 0x000fea0003800000 */
        /*0040*/                   ATOMS.CAST.SPIN R6, [R7], R8, R9 ;            /* 0x000000080706738d */
                                                                                 /* 0x000e2400058e0009 */
        /*0050*/                   REDG.E.ADD.F32.FTZ.RN.STRONG.GPU desc[UR4][R10.64], R12 ; /* 0x0000000c0a00798e */
                                                                                 /* 0x000fe2000c10e784 */
.L_x_2:
        /*0060*/                   VOTE.ANY R13, PT, P1 ;                        /* 0x00000000000d7806 */
                                                                                 /* 0x000fe200008e0100 */
        /*0070*/               @P1 BRA `(.L_x_1) ;                               /* 0xfffffffc00e41947 */
                                                                                 /* 0x000fea000383ffff */
        /*0080*/                   EXIT ;                                        /* 0x000000000000794d */
                                                                                 /* 0x000fea0003800000 */
.L_x_3:
        /*0090*/                   BRA `(.L_x_3);                                /* 0xfffffffc00fc7947 */
                                                                                 /* 0x000fc0000383ffff */
		..........
"""

PTXAS = f"""
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{OTHER}' for 'sm_90a'
ptxas info    : Function properties for {OTHER}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 14 registers, used 0 barriers, 376 bytes cmem[0]
ptxas info    : Compiling entry function '{LADDER}' for 'sm_90a'
ptxas info    : Function properties for {LADDER}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2080 bytes smem, 448 bytes cmem[0]
ptxas info    : Compiling entry function '{L2}' for 'sm_90a'
ptxas info    : Function properties for {L2}
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 18432 bytes smem, 464 bytes cmem[0]
"""


def test_variant_names_read_the_template_arguments():
    assert variant_name(LADDER) == "march_ladder_kernel<f32,0,0,1>"
    assert variant_name(LADDER.replace("IfLb0", "IhLb0")) == (
        "march_ladder_kernel<u8,0,0,1>")
    assert variant_name(L2) == "l2_step_kernel<0,1,1,1>"
    assert variant_name(OTHER) is None


def test_parse_sass_keeps_the_kernels_their_branches_and_no_nop():
    insts = parse_sass(SASS)
    assert set(insts) == {"march_ladder_kernel<f32,0,0,1>",
                          "l2_step_kernel<0,1,1,1>"}
    ladder = insts["march_ladder_kernel<f32,0,0,1>"]
    assert len(ladder) == 30  # 32 instructions, two NOP
    assert ("NOP" not in {op for _, op, _ in ladder})
    assert (0x1a0, "BRA", 0x80) in ladder
    step = insts["l2_step_kernel<0,1,1,1>"]
    # Labels resolve to the address of the instruction after them.
    assert (0x30, "BRA", 0x60) in step and (0x70, "BRA", 0x10) in step
    assert (0x90, "BRA", 0x90) in step


def test_march_loop_is_the_longest_backward_branch():
    insts = parse_sass(SASS)
    loop = march_loop(insts["march_ladder_kernel<f32,0,0,1>"])
    assert (loop[0][0], loop[-1][0]) == (0x80, 0x1a0)
    assert len(loop) == 18  # 0x80..0x1a0, the NOP at 0x160 left out
    loop = march_loop(insts["l2_step_kernel<0,1,1,1>"])
    assert [a for a, _, _ in loop] == [0x10, 0x20, 0x30, 0x40, 0x50, 0x60,
                                       0x70]
    assert march_loop([(0, "EXIT", None)]) == []


def test_sass_counts_by_class_and_scatter_opcode():
    counts = sass_counts(SASS)
    assert set(counts) == {"march_ladder_kernel", "l2_step_kernel"}
    ladder = counts["march_ladder_kernel"]["variants"][
        "march_ladder_kernel<f32,0,0,1>"]
    assert ladder["loop"] == {
        "fp32": 4,    # FMUL, FADD, FADD.RM, FFMA
        "int": 5,     # IADD3, VIMNMX, IMAD.WIDE, ISETP, SEL
        "conv": 3,    # F2I, I2FP, FRND
        "ldg": 1, "lds": 1, "mufu": 1,
        "branch": 1,  # the loop's own BRA
        "other": 2,   # PRMT, FSETP
        "total": 18}
    assert ladder["kernel"]["total"] == 30
    assert ladder["kernel"]["branch"] == 6  # EXIT x2, BSSY, BSYNC, BRA x2
    assert ladder["kernel"]["lds"] == 2
    assert set(ladder["kernel"]) == {*OPCODE_CLASSES, "other", "total"}
    # The scatter's opcodes, summed over a kernel's variants, keep their
    # names; the ladder has none.
    step = counts["l2_step_kernel"]
    assert {k: v for k, v in step.items() if k != "variants"} == {
        "MATCH": 1, "SHFL": 1, "ATOMS": 1, "REDG": 1, "VOTE": 1}
    assert set(counts["march_ladder_kernel"]) == {"variants"}
    assert step["variants"]["l2_step_kernel<0,1,1,1>"]["loop"]["total"] == 7


def test_ptxas_report_names_each_variant():
    rep = ptxas_report(PTXAS)
    assert rep == {
        "march_ladder_kernel": {"registers": [40], "spill_bytes": [0],
                                "variants": ["march_ladder_kernel<f32,0,0,1>"]},
        "l2_step_kernel": {"registers": [80], "spill_bytes": [8],
                           "variants": ["l2_step_kernel<0,1,1,1>"]}}


def test_issue_yardstick():
    # 180 instructions over 8.4e6 warp-steps on 528 schedulers at 1980 MHz.
    assert abs(issue_ms(180, 8_400_000, 1980.0) - 1.4463) < 1e-4
