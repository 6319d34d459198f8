/* C client of libopttpu_torch — the analogue of tests/minimal
 * (reference: tests/minimal/main.cpp:10-62), after native/test/test_client.c:
 * WxH laplacian smoothing of random noise through the C API, verifying the
 * cost decreases, the unknown buffer is written back and plans can be made
 * and freed in a loop.
 *
 *   client [W H nIterations lIterations [out_path]]   (defaults 64 64 3 30)
 *
 * Run from the repository root (it loads native/test/laplacian_spec.py).
 * It prints the initial and final costs with %.9g and writes A, then the
 * written-back X, as raw float32 (W*H values each) to out_path. The plans
 * run where OPT_TPU_TORCH_DEVICE says (cpu or cuda; unset: cuda). */

#include <stdio.h>
#include <stdlib.h>

#include "OptTpu.h"

int main(int argc, char** argv) {
    const uint32_t W = argc > 1 ? (uint32_t)atoi(argv[1]) : 64;
    const uint32_t H = argc > 2 ? (uint32_t)atoi(argv[2]) : 64;
    const int n_iter = argc > 3 ? atoi(argv[3]) : 3;
    const int l_iter = argc > 4 ? atoi(argv[4]) : 30;
    const char* out_path = argc > 5 ? argv[5] : NULL;

    Opt_InitializationParameters ip = {0, 1, 0, 0};
    Opt_State* state = Opt_NewState(ip);
    if (!state) { fprintf(stderr, "NewState failed: %s\n", Opt_LastError()); return 1; }

    Opt_Problem* prob =
        Opt_ProblemDefine(state, "native/test/laplacian_spec.py", "gaussNewtonGPU");
    if (!prob) { fprintf(stderr, "ProblemDefine failed: %s\n", Opt_LastError()); return 1; }

    uint32_t dims[2] = {W, H};
    Opt_Plan* plan = Opt_ProblemPlan(state, prob, dims, 2);
    if (!plan) { fprintf(stderr, "ProblemPlan failed: %s\n", Opt_LastError()); return 1; }

    Opt_SetSolverParameter(state, plan, "nIterations", n_iter);
    Opt_SetSolverParameter(state, plan, "lIterations", l_iter);

    float* x = (float*)malloc(sizeof(float) * W * H);
    float* a = (float*)malloc(sizeof(float) * W * H);
    srand(42);
    for (uint32_t i = 0; i < W * H; ++i) {
        a[i] = (float)rand() / (float)RAND_MAX;
        x[i] = a[i];
    }
    float x0_first = x[0];

    void* data[2] = {x, a};
    Opt_ProblemInit(state, plan, data, 2);
    double init_cost = Opt_ProblemCurrentCost(state, plan);
    while (Opt_ProblemStep(state, plan)) {
        printf("cost: %.9g\n", Opt_ProblemCurrentCost(state, plan));
    }
    double final_cost = Opt_ProblemCurrentCost(state, plan);
    printf("init=%.9g final=%.9g\n", init_cost, final_cost);

    if (out_path) {
        FILE* f = fopen(out_path, "wb");
        if (!f || fwrite(a, sizeof(float), W * H, f) != W * H ||
            fwrite(x, sizeof(float), W * H, f) != W * H || fclose(f) != 0) {
            fprintf(stderr, "FAIL: cannot write %s\n", out_path);
            return 5;
        }
    }
    if (!(final_cost < init_cost)) {
        fprintf(stderr, "FAIL: cost did not decrease\n");
        return 2;
    }
    if (x[0] == x0_first) {
        fprintf(stderr, "FAIL: unknown buffer not written back\n");
        return 3;
    }

    /* lifecycle cycling (reference tests/create_delete_cycle/main.cpp:22-27) */
    for (int i = 0; i < 10; ++i) {
        Opt_Plan* p2 = Opt_ProblemPlan(state, prob, dims, 2);
        if (!p2) { fprintf(stderr, "plan cycle failed: %s\n", Opt_LastError()); return 4; }
        Opt_PlanFree(state, p2);
    }

    Opt_PlanFree(state, plan);
    Opt_ProblemDelete(state, prob);
    Opt_FreeState(state);
    free(x);
    free(a);
    printf("PASS\n");
    return 0;
}
